"""Evaluation-harness core: LM interface, the PyTorch-backed LM, task bases.

Counterpart of ``omniquant_tpu/eval/harness/base.py`` (a re-design of the
reference's vendored EleutherAI harness, lm_eval/base.py:20-891): the three
request types (loglikelihood, loglikelihood_rolling, greedy_until),
descending-length batching, rolling windows, MultipleChoice acc/acc_norm,
and Perplexity word/byte metrics. ``TorchLM`` scores with the family's
forward on the device (a packed model's linears run its kernels) and
generates with the serving engine.
"""
from __future__ import annotations

import abc
import dataclasses
import re
from collections import defaultdict
from typing import Iterable, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# LM interface
# ---------------------------------------------------------------------------

class LM(abc.ABC):
    """The three request primitives (reference lm_eval/base.py:843-847)."""

    @abc.abstractmethod
    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """[(context, continuation)] -> [(logprob, is_greedy)]"""

    @abc.abstractmethod
    def loglikelihood_rolling(self, requests) -> List[float]:
        """[(string,)] -> [sum logprob over rolling windows]"""

    @abc.abstractmethod
    def greedy_until(self, requests) -> List[str]:
        """[(context, until_list)] -> [generated string]"""


def get_rolling_token_windows(token_list, prefix_token, max_seq_len,
                              context_len):
    """Reference lm_eval/utils.py:72-110 semantics: overlapping windows whose
    predicted portions are disjoint and cover every token exactly once."""
    assert 1 <= context_len <= max_seq_len
    pred_len = max_seq_len - context_len + 1
    predicted = 0
    first_seq_len = min(max_seq_len, len(token_list))
    yield ([prefix_token] + token_list[: first_seq_len - 1],
           token_list[:first_seq_len])
    predicted += first_seq_len
    while predicted < len(token_list):
        window_pred_len = min(len(token_list) - predicted, pred_len)
        window_end = predicted + window_pred_len
        yield (
            token_list[window_end - max_seq_len - 1 : window_end - 1],
            token_list[window_end - window_pred_len : window_end],
        )
        predicted += window_pred_len


def make_disjoint_window(pair):
    """Reference lm_eval/utils.py:113-116."""
    a, b = pair
    return a[: len(a) - (len(b) - 1)], b


class Reorderer:
    """Descending-length sort for stable batching (lm_eval/utils.py:119-143)."""

    def __init__(self, arr, fn):
        self.size = len(arr)
        arr = list(enumerate(arr))
        grouped = defaultdict(list)
        for idx, x in arr:
            grouped[fn(x)].append((idx, x))
        self.arr = sorted(grouped.items(), key=lambda x: x[0], reverse=True)
        self.arr = [(idxs, key) for key, idxs in self.arr]

    def get_reordered(self):
        return [x for idxs, _ in self.arr for _, x in idxs]

    def get_original(self, newarr):
        res = [None] * self.size
        it = iter(newarr)
        for idxs, _ in self.arr:
            for idx, _x in idxs:
                res[idx] = next(it)
        return res


class TorchLM(LM):
    """LM over an omniquant_tpu_torch model (the LMClass analog, reference
    models/LMClass.py + models/models_utils.py:257-432), on ``device``.

    Scoring runs ``family.forward`` on each chunk of ``batch_size``
    requests, longest first, padded on the right to the chunk's longest
    sequence (causal masking keeps every request's result what it is
    alone); ``greedy_until`` runs the family's serving engine, built once
    with ``max_batch=batch_size`` and ``max_len=seqlen``. Both run the model
    in ``dtype`` (by default that of the first floating leaf of ``params``,
    dict keys in sorted order): the floating tensors of ``params``, packed
    scales, zeros and biases too, are cast to it, as an engine casts
    them."""

    def __init__(self, family, params, model_cfg, tokenizer,
                 seqlen: int = 2048, batch_size: int = 4, spec=None,
                 max_gen_toks: int = 256, tp_mesh=None, device="cuda",
                 dtype=None):
        from ... import resolve_device
        from ...models.common import NO_ACT_QUANT
        from ...serving.engine import _to_engine

        if tp_mesh is not None:
            raise NotImplementedError(
                "tensor-parallel generation (tp_mesh) needs the parallel "
                "layer (ROADMAP Queue 1 item 9)")
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else _first_float_dtype(params)
        self.family = family
        self.params = _to_engine(params, self.device, self.dtype)
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.seqlen = seqlen
        self.batch_size = batch_size
        self.spec = spec if spec is not None else NO_ACT_QUANT
        self.max_gen_toks = max_gen_toks
        self.tp_mesh = tp_mesh
        self._engine = None

    def _logprobs(self, tokens):
        """tokens (B, L) int64 on the device -> (2, B, L-1) f32 on the host:
        [0] each target's log-probability, [1] 1.0 where it is the argmax.
        The forward takes tokens[:, :-1]: the last token is only a target
        (JAX's forward also takes it, and its logits go unused; a window of
        seqlen + 1 tokens would put it past OPT's learned positions)."""
        import torch

        with torch.inference_mode():
            logits = self.family.forward(self.params, tokens[:, :-1],
                                         self.cfg, self.spec)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt = tokens[:, 1:]
            tok_lp = logp.gather(-1, tgt[..., None])[..., 0]
            greedy = logp.argmax(-1) == tgt
            return torch.stack([tok_lp, greedy.float()]).cpu().numpy()

    def _next_token(self, tokens):
        """Greedy next token after a (1, L) prefix."""
        import torch

        with torch.inference_mode():
            logits = self.family.forward(self.params, tokens, self.cfg,
                                         self.spec)
            return int(logits[0, -1].float().argmax())

    # -- tokenization ------------------------------------------------------
    def tok_encode(self, string: str):
        return self.tokenizer.encode(string, add_special_tokens=False)

    def tok_decode(self, tokens):
        return self.tokenizer.decode(tokens)

    @property
    def eot_token_id(self):
        tid = getattr(self.tokenizer, "eos_token_id", None)
        return tid if tid is not None else 0

    # -- scoring -----------------------------------------------------------
    def _score_token_batches(self, token_pairs):
        """token_pairs: [(ctx_tokens, cont_tokens)] -> [(ll, greedy)]."""
        import torch

        results = [None] * len(token_pairs)
        order = sorted(
            range(len(token_pairs)),
            key=lambda i: -(len(token_pairs[i][0]) + len(token_pairs[i][1])))
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            seqs, cont_lens = [], []
            for i in chunk:
                ctx, cont = token_pairs[i]
                seq = (list(ctx) + list(cont))[-(self.seqlen + 1):]
                seqs.append(seq)
                cont_lens.append(len(cont))
            maxlen = max(len(s) for s in seqs)
            batch = np.zeros((len(chunk), maxlen), np.int64)
            for r, s in enumerate(seqs):
                batch[r, : len(s)] = s
            tok_lp, greedy = self._logprobs(
                torch.as_tensor(batch, device=self.device))
            for r, i in enumerate(chunk):
                L = len(seqs[r])
                cl = cont_lens[r]
                sl = slice(L - 1 - cl, L - 1)
                results[i] = (
                    float(tok_lp[r, sl].sum()), bool(greedy[r, sl].all()))
        return results

    def loglikelihood(self, requests):
        pairs = []
        for context, continuation in requests:
            if context == "":
                ctx_tokens = [self.eot_token_id]
            else:
                ctx_tokens = self.tok_encode(context)
            cont_tokens = self.tok_encode(continuation)
            pairs.append((ctx_tokens, cont_tokens))
        return self._score_token_batches(pairs)

    def loglikelihood_rolling(self, requests):
        out = []
        for (string,) in requests:
            tokens = self.tok_encode(string)
            windows = [
                make_disjoint_window(w)
                for w in get_rolling_token_windows(
                    tokens, self.eot_token_id, self.seqlen, 1)
            ]
            scores = self._score_token_batches(windows)
            out.append(sum(s for s, _ in scores))
        return out

    def _get_engine(self):
        """Lazily build the family's serving engine over the same params
        for KV-cached generation."""
        if self._engine is None:
            from ...serving.engine import FalconEngine, LlamaEngine, OPTEngine

            eng_cls = {"llama": LlamaEngine, "opt": OPTEngine,
                       "falcon": FalconEngine}[self.family.name]
            self._engine = eng_cls(
                self.params, self.cfg, max_batch=self.batch_size,
                max_len=self.seqlen, dtype=self.dtype, spec=self.spec,
                device=self.device)
        return self._engine

    def greedy_until(self, requests):
        eng = self._get_engine()
        out = [None] * len(requests)
        keep = max(1, self.seqlen - self.max_gen_toks)

        def finalize(idx, generated, until):
            text = self.tok_decode(generated)
            for u in until:
                cut = text.find(u)
                if cut != -1:
                    text = text[:cut]
            out[idx] = text

        for start in range(0, len(requests), eng.max_batch):
            wave = list(range(start, min(start + eng.max_batch,
                                         len(requests))))
            prompts, untils = [], []
            for i in wave:
                context, until = requests[i]
                untils.append([until] if isinstance(until, str) else until)
                prompts.append(
                    self.tok_encode(context)[-keep:] or [self.eot_token_id])
            slots = eng.add_requests(prompts)
            slot_req = dict(zip(slots, wave))
            # cache capacity caps generation: prompt + gen <= engine max_len
            gen_cap = {
                s: min(self.max_gen_toks,
                       eng.max_len - len(prompts[slot_req[s] - start]))
                for s in slots
            }
            generated = {s: [eng._pending_next[s]] for s in slots}
            live = {}
            for s in slots:
                i = slot_req[s]
                gen = generated[s]
                text = self.tok_decode(gen)
                u = untils[i - start]
                if (any(x in text for x in u)
                        or gen[-1] == self.eot_token_id
                        or len(gen) >= gen_cap[s]):
                    finalize(i, gen, u)
                else:
                    live[s] = gen[-1]
            while live:
                # decode up to 8 tokens per device dispatch (the host link
                # dominates per-step latency); stop conditions are applied
                # token-by-token within the chunk, truncating exactly where
                # single-step decoding would have stopped
                n = min(8, min(gen_cap[s] - len(generated[s])
                               for s in live))
                if n <= 0:
                    for s in list(live):
                        finalize(slot_req[s], generated[s],
                                 untils[slot_req[s] - start])
                    break
                chunks = eng.step_n(live, n)
                live = {}
                for s, toks in chunks.items():
                    i = slot_req[s]
                    gen = generated[s]
                    u = untils[i - start]
                    done = False
                    for tok in toks:
                        gen.append(tok)
                        text = self.tok_decode(gen)
                        if (any(x in text for x in u)
                                or tok == self.eot_token_id
                                or len(gen) >= gen_cap[s]):
                            finalize(i, gen, u)
                            done = True
                            break
                    if not done:
                        live[s] = gen[-1]
            for s in list(live):  # hit max_gen_toks mid-flight
                finalize(slot_req[s], generated[s], untils[slot_req[s] - start])
            for s in slots:
                eng.release(s)
        return out

    def _greedy_until_uncached(self, requests):
        """The O(n^2) path (full forward per generated token); the oracle
        the tests hold the engine-backed greedy_until to."""
        import torch

        out = []
        for context, until in requests:
            if isinstance(until, str):
                until = [until]
            keep = max(1, self.seqlen - self.max_gen_toks)
            ctx = self.tok_encode(context)[-keep:] or [self.eot_token_id]
            toks = list(ctx)
            generated = []
            for _ in range(self.max_gen_toks):
                window = toks[-self.seqlen:]
                nxt = self._next_token(torch.as_tensor(
                    [window], dtype=torch.int64, device=self.device))
                generated.append(nxt)
                toks.append(nxt)
                text = self.tok_decode(generated)
                if any(u in text for u in until) or nxt == self.eot_token_id:
                    break
            text = self.tok_decode(generated)
            for u in until:
                idx = text.find(u)
                if idx != -1:
                    text = text[:idx]
            out.append(text)
        return out


def _first_float_dtype(tree):
    """The dtype of the first floating tensor of ``tree``, dict keys in
    sorted order (the order of jax.tree.leaves)."""
    import torch

    from ...quant.packing import PackedWeight

    if isinstance(tree, PackedWeight):
        tree = tree.scales
    if isinstance(tree, torch.Tensor):
        return tree.dtype if tree.is_floating_point() else None
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dt = _first_float_dtype(v)
            if dt is not None:
                return dt
    return None


# ---------------------------------------------------------------------------
# Requests & tasks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    request_type: str
    args: tuple
    index: Optional[int] = None  # None = deliver the full response tuple

    def __iter__(self):
        for i in range(self._expected_len()):
            yield Request(self.request_type, self.args, i)

    def __getitem__(self, i):
        return Request(self.request_type, self.args, i)

    def _expected_len(self):
        return 2 if self.request_type == "loglikelihood" else 1


class RequestFactory:
    """`rf` — builds typed requests (reference lm_eval/base.py:850-891)."""

    def __getattr__(self, attr):
        def fn(*args):
            return Request(attr, args)
        return fn


rf = RequestFactory()


class Task(abc.ABC):
    VERSION = 0
    DATASET_PATH: Optional[str] = None
    DATASET_NAME: Optional[str] = None

    def __init__(self, data=None):
        self._data = data
        self._training_docs = None
        self._fewshot_docs = None

    # data access ----------------------------------------------------------
    def download(self):
        from datasets import load_dataset

        if self._data is None:
            self._data = load_dataset(self.DATASET_PATH, self.DATASET_NAME)

    @property
    def data(self):
        if self._data is None:
            self.download()
        return self._data

    @abc.abstractmethod
    def has_validation_docs(self):
        ...

    @abc.abstractmethod
    def has_test_docs(self):
        ...

    def has_training_docs(self):
        return False

    def training_docs(self):
        return []

    def validation_docs(self):
        return []

    def test_docs(self):
        return []

    # prompting ------------------------------------------------------------
    @abc.abstractmethod
    def doc_to_text(self, doc):
        ...

    @abc.abstractmethod
    def doc_to_target(self, doc):
        ...

    def fewshot_description(self):
        return ""

    # decontamination hooks (reference lm_eval/base.py Task):
    # tasks that opt in expose the text to scan for train-set overlap
    def should_decontaminate(self):
        return False

    def doc_to_decontamination_query(self, doc):
        raise NotImplementedError(
            "override when should_decontaminate() is True")

    @classmethod
    def enable_decontamination(cls, query_fn):
        """Attach the decontamination hooks (query_fn: doc -> str). The
        reference hand-writes these two methods on ~30 task classes; here
        the per-task extractors are declared in one table per module."""
        cls.should_decontaminate = lambda self: True
        cls.doc_to_decontamination_query = (
            lambda self, doc, _fn=query_fn: _fn(doc))

    def fewshot_context(self, doc, num_fewshot, rnd):
        description = self.fewshot_description()
        description = description + "\n\n" if description else ""
        if num_fewshot == 0:
            labeled = ""
        else:
            if self.has_training_docs():
                docs = self._fewshot_source(rnd, num_fewshot + 1)
            else:
                docs = list(self.validation_docs() or self.test_docs())
                docs = rnd.sample(docs, num_fewshot + 1)
            docs = [d for d in docs if d != doc][:num_fewshot]
            labeled = "\n\n".join(
                self.doc_to_text(d) + self.doc_to_target(d) for d in docs
            ) + "\n\n"
        return description + labeled + self.doc_to_text(doc)

    def _fewshot_source(self, rnd, k):
        if self._training_docs is None:
            self._training_docs = list(self.training_docs())
        return rnd.sample(self._training_docs, k)

    # scoring --------------------------------------------------------------
    @abc.abstractmethod
    def construct_requests(self, doc, ctx):
        ...

    @abc.abstractmethod
    def process_results(self, doc, results):
        ...

    @abc.abstractmethod
    def aggregation(self):
        ...

    @abc.abstractmethod
    def higher_is_better(self):
        ...


class MultipleChoiceTask(Task):
    """acc + length-normalized acc_norm (reference lm_eval/base.py:645-678)."""

    def doc_to_target(self, doc):
        return " " + doc["choices"][doc["gold"]]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, " {}".format(choice))[0]
            for choice in doc["choices"]
        ]

    def process_results(self, doc, results):
        gold = doc["gold"]
        acc = 1.0 if np.argmax(results) == gold else 0.0
        completion_len = np.array(
            [float(len(i)) for i in doc["choices"]])
        acc_norm = 1.0 if np.argmax(results / completion_len) == gold else 0.0
        return {"acc": acc, "acc_norm": acc_norm}

    def aggregation(self):
        from .metrics import mean

        return {"acc": mean, "acc_norm": mean}

    def higher_is_better(self):
        return {"acc": True, "acc_norm": True}


class PerplexityTask(Task):
    """Word/byte perplexity over rolling windows
    (reference lm_eval/base.py:681-780)."""

    def has_training_docs(self):
        return False

    def fewshot_context(self, doc, num_fewshot, rnd):
        assert num_fewshot == 0, "perplexity tasks have no fewshot"
        return ""

    def doc_to_text(self, doc):
        return ""

    def doc_to_target(self, doc):
        return doc

    def construct_requests(self, doc, ctx):
        assert not ctx
        return [rf.loglikelihood_rolling(self.doc_to_target(doc))[0]]

    def process_results(self, doc, results):
        (loglikelihood,) = results
        words = self.count_words(doc)
        bytes_ = self.count_bytes(doc)
        return {
            "word_perplexity": (loglikelihood, words),
            "byte_perplexity": (loglikelihood, bytes_),
            "bits_per_byte": (loglikelihood, bytes_),
        }

    def aggregation(self):
        from .metrics import bits_per_byte, weighted_perplexity

        return {
            "word_perplexity": weighted_perplexity,
            "byte_perplexity": weighted_perplexity,
            "bits_per_byte": bits_per_byte,
        }

    def higher_is_better(self):
        return {"word_perplexity": False, "byte_perplexity": False,
                "bits_per_byte": False}

    @classmethod
    def count_bytes(cls, doc):
        return len(doc.encode("utf-8"))

    @classmethod
    def count_words(cls, doc):
        return len(re.split(r"\s+", doc))
