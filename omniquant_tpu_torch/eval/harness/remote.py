"""Remote-API LM adapters (OpenAI-completions-style and TextSynth-style).

Role equivalents of the reference's `lm_eval/models/gpt3.py` and
`lm_eval/models/textsynth.py`: evaluate harness tasks against a hosted
completion API instead of a local model. Redesigned for testability — the
HTTP layer is an injectable `transport` callable, so the full adapter logic
(request shaping, chunking, echo-logprob slicing, greedy-match detection,
retry/backoff) runs in offline tests with a fake transport
(tests/test_remote_lm.py); production use supplies a real transport, e.g.

    def transport(payload):            # OpenAI completions
        r = requests.post(url, headers=auth, json=payload, timeout=60)
        r.raise_for_status()
        return r.json()

Reference parity notes:
  * OpenAICompletionLM mirrors gpt3.py: REQ_CHUNK_SIZE=20 batched prompts,
    echo=True max_tokens=0 scoring, `get_result`'s continuation-logprob sum
    + is-greedy check (gpt3.py:10-35), descending-length Reorderer,
    same-until chunking for generation (gpt3.py:168-186), context window
    max_length+1 with left truncation (gpt3.py:137-143).
  * TextSynthStyleLM mirrors textsynth.py: per-request string
    logprob/completions calls; loglikelihood_rolling raises (the API has no
    tokenized input — textsynth.py:110-118).
  * Retry with 3s exponential (x1.5) backoff on transport errors
    (gpt3.py:38-53); the sleeper is injectable so tests don't wait.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from .base import LM, Reorderer, get_rolling_token_windows, \
    make_disjoint_window


def retry_with_backoff(fn, sleeper=time.sleep, max_tries: int = 8,
                       backoff: float = 3.0, factor: float = 1.5):
    """Call fn() until it returns; exponential back-off on exceptions."""
    t = backoff
    for i in range(max_tries):
        try:
            return fn()
        except Exception:
            if i == max_tries - 1:
                raise
            sleeper(t)
            t *= factor
    raise RuntimeError("unreachable")


def get_result(choice: dict, ctxlen: int):
    """Continuation logprob sum + exact-greedy flag from an echo'd
    completions choice (reference gpt3.py:10-35)."""
    logprobs = choice["logprobs"]["token_logprobs"]
    continuation_logprobs = sum(logprobs[ctxlen:])
    is_greedy = True
    for i in range(ctxlen, len(choice["logprobs"]["tokens"])):
        token = choice["logprobs"]["tokens"][i]
        top_tokens = choice["logprobs"]["top_logprobs"][i]
        top_token = max(top_tokens.keys(), key=lambda x: top_tokens[x])
        if top_token != token:
            is_greedy = False
            break
    return continuation_logprobs, is_greedy


class OpenAICompletionLM(LM):
    """Completions-API adapter (the reference's `gpt3` backend).

    transport(payload: dict) -> response dict with a "choices" list; each
    choice carries "logprobs" (echo scoring) or "text" (generation).
    tok_encode/tok_decode: token codec callables (tests inject stubs; real
    use passes a GPT-2 tokenizer's methods).
    """

    REQ_CHUNK_SIZE = 20

    def __init__(self, transport: Callable[[dict], dict],
                 tok_encode: Callable[[str], List[int]],
                 tok_decode: Callable[[Sequence[int]], str],
                 eot_token_id: int = 50256,
                 max_length: int = 2048, max_gen_toks: int = 256,
                 truncate: bool = False, sleeper=time.sleep):
        self.transport = transport
        self.tok_encode = tok_encode
        self.tok_decode = tok_decode
        self.eot_token_id = eot_token_id
        self.max_length = max_length
        self.max_gen_toks = max_gen_toks
        self.truncate = truncate
        self.sleeper = sleeper

    def _complete(self, payload: dict) -> dict:
        return retry_with_backoff(
            lambda: self.transport(payload), sleeper=self.sleeper)

    # -- loglikelihood ---------------------------------------------------
    def loglikelihood(self, requests):
        pairs = []
        for context, continuation in requests:
            if context == "":
                context_enc = [self.eot_token_id]
            else:
                context_enc = self.tok_encode(context)
            continuation_enc = self.tok_encode(continuation)
            pairs.append(((context, continuation), context_enc,
                          continuation_enc))
        return self._loglikelihood_tokens(pairs)

    def _loglikelihood_tokens(self, requests):
        res = []

        def _collate(x):
            toks = x[1] + x[2]
            return -len(toks), tuple(toks)

        re_ord = Reorderer(list(requests), _collate)
        ordered = re_ord.get_reordered()
        for start in range(0, len(ordered), self.REQ_CHUNK_SIZE):
            chunk = ordered[start : start + self.REQ_CHUNK_SIZE]
            inps, ctxlens = [], []
            for _key, context_enc, continuation_enc in chunk:
                # API window is max_length+1 (first token is input-only)
                inp = (context_enc + continuation_enc)[-(self.max_length + 1):]
                ctxlen = len(context_enc) - max(
                    0, len(context_enc) + len(continuation_enc)
                    - (self.max_length + 1))
                inps.append(inp)
                ctxlens.append(ctxlen)
            response = self._complete({
                "prompt": inps, "echo": True, "max_tokens": 0,
                "temperature": 0.0, "logprobs": 10,
            })
            for choice, ctxlen, _req in zip(
                    response["choices"], ctxlens, chunk):
                res.append(get_result(choice, ctxlen))
        return re_ord.get_original(res)

    def loglikelihood_rolling(self, requests):
        out = []
        for (string,) in requests:
            tokens = self.tok_encode(string)
            windows = [
                make_disjoint_window(w)
                for w in get_rolling_token_windows(
                    tokens, self.eot_token_id, self.max_length, 1)
            ]
            scores = self._loglikelihood_tokens(
                [(None, ctx, cont) for ctx, cont in windows])
            out.append(sum(s for s, _ in scores))
        return out

    # -- generation ------------------------------------------------------
    def greedy_until(self, requests):
        if not requests:
            return []
        res = []

        def _collate(x):
            toks = self.tok_encode(x[0])
            return len(toks), x[0]

        re_ord = Reorderer(list(requests), _collate)

        def sameuntil_chunks(xs, size):
            ret, lastuntil = [], xs[0][1]
            for x in xs:
                if len(ret) >= size or x[1] != lastuntil:
                    yield ret, lastuntil
                    ret, lastuntil = [], x[1]
                ret.append(x)
            if ret:
                yield ret, lastuntil

        for chunk, until in sameuntil_chunks(
                re_ord.get_reordered(), self.REQ_CHUNK_SIZE):
            inps = []
            for context, _ in chunk:
                context_enc = self.tok_encode(context)
                inps.append(
                    context_enc[-(self.max_length - self.max_gen_toks):])
            until_list = [until] if isinstance(until, str) else list(until)
            response = self._complete({
                "prompt": inps, "max_tokens": self.max_gen_toks,
                "temperature": 0.0, "logprobs": 10, "stop": until_list,
            })
            for choice, _req in zip(response["choices"], chunk):
                text = choice["text"]
                for u in until_list:
                    cut = text.find(u)
                    if cut != -1:
                        text = text[:cut]
                res.append(text)
        return re_ord.get_original(res)


class TextSynthStyleLM(LM):
    """String-based logprob/completions API adapter (the reference's
    `textsynth` backend). transport(path: str, payload: dict) -> dict."""

    def __init__(self, transport: Callable[[str, dict], dict],
                 max_gen_toks: int = 256, sleeper=time.sleep):
        self.transport = transport
        self.max_gen_toks = max_gen_toks
        self.sleeper = sleeper

    def loglikelihood(self, requests):
        res = []
        for context, continuation in requests:
            resp = retry_with_backoff(
                lambda: self.transport(
                    "logprob",
                    {"context": context, "continuation": continuation}),
                sleeper=self.sleeper)
            assert "logprob" in resp, resp
            res.append((resp["logprob"], resp["is_greedy"]))
        return res

    def loglikelihood_rolling(self, requests):
        # reference parity: the API has no tokenized input, so rolling
        # windows cannot be formed (textsynth.py:110-118)
        raise NotImplementedError(
            "loglikelihood_rolling is not supported by string-based APIs")

    def greedy_until(self, requests):
        res = []
        for context, until in requests:
            until_list = [until] if isinstance(until, str) else list(until)
            resp = retry_with_backoff(
                lambda: self.transport(
                    "completions",
                    {"prompt": context, "max_tokens": self.max_gen_toks,
                     "top_k": 1, "stop": until_list}),
                sleeper=self.sleeper)
            assert "text" in resp, resp
            res.append(resp["text"])
        return res
