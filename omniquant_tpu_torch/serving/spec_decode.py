"""Speculative decoding over the serving engines.

Counterpart of ``omniquant_tpu/serving/spec_decode.py``. A sequential
decode step streams every packed weight once per token; here a cheap DRAFT
proposes ``gamma`` tokens, the TARGET scores ``[last, p_1..p_gamma]`` in one
``verify_step`` (one weight pass for gamma + 1 tokens), and the longest
prefix of proposals equal to the target's argmaxes is accepted, plus the
target's own next token. With greedy acceptance the emitted stream is the
target's greedy stream; the draft moves only the speed.

The default draft is the target's first ``draft_layers`` blocks with its
final norm and head (layer-skip self-speculation). It shares the target's
buffers: the engine leaves an already prepped layer as it is and
``_to_engine`` hands back the tensors themselves, so the draft adds only
its KV cache (and, with ``draft_head_bits``, its packed head).

Both engines attend positions ``<= lengths`` and write at ``lengths + i``,
so rejected rows are never attended and later writes overwrite them;
accepting is ``lengths += emitted`` on the host, and the draft's lengths
are set to the target's every round. The draft runs gamma + 1 steps so that
a fully accepted round leaves no hole at ``L + gamma`` in its cache.

``spec_steps`` runs several greedy rounds with every tensor on the device
(the JAX package compiles them into one program; PyTorch runs them eagerly
from one Python loop): the draft's decode steps and argmaxes, the target's
verify pass, the accepted counts from a cumulative product of matches, and
the next lengths. The host builds the inputs once before the loop and
copies the (rounds, B, gamma + 1) tokens and (rounds, B) counts back once
after it. ``sample_spec_step`` is the sampling mode (rejection-sampling
acceptance, host-paced). The JAX package's tensor-parallel branch waits for
the port's parallel layer.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch


def layer_skip_params(params: dict, n_layers: int) -> dict:
    """Draft params for layer-skip self-speculation: the first n_layers
    blocks (the same dicts, no copy) with the target's embedding, norm and
    head."""
    draft = dict(params)
    draft["layers"] = list(params["layers"][:n_layers])
    return draft


def _packed_head(params: dict, bits: int):
    """The draft's head packed at ``bits`` (g128 where the hidden size
    allows, else per channel): ``lm_head``, or the tied embedding."""
    from ..quant import QuantConfig, pack_weight

    emb = params.get("lm_head")
    if emb is None:
        emb = params.get("embed_tokens", params.get("word_embeddings"))
    gs = 128 if emb.shape[1] % 128 == 0 else None
    return pack_weight(emb.float(), QuantConfig(n_bits=bits, group_size=gs),
                       layout="auto")


class SpecDecoder:
    """Greedy speculative decoding over a (target, draft) engine pair.

    target: a LlamaEngine, OPTEngine or FalconEngine; its greedy stream is
        reproduced. draft: an engine with the same vocabulary; by default a
        layer-skip self-draft of ``draft_layers`` blocks of the target.
    gamma: proposals per round; a round costs gamma + 1 draft steps and one
        verify pass of the target, and emits 1..gamma + 1 tokens.
    draft_head_bits: pack the default draft's head at these bits (the
        target's head, whose argmaxes define the stream, is untouched).
    """

    def __init__(self, target, draft=None, draft_layers: int = 4,
                 gamma: int = 4, draft_head_bits: Optional[int] = None):
        self.target = target
        self.gamma = gamma
        if draft is None:
            d = min(draft_layers, len(target.params["layers"]))
            # OPT and Falcon engines keep a llama-named view at .cfg and
            # their family's config at _ocfg / _fcfg
            base_cfg = getattr(target, "_fcfg",
                               getattr(target, "_ocfg", target.cfg))
            dparams = layer_skip_params(target.params, d)
            if draft_head_bits:
                dparams["lm_head"] = _packed_head(dparams, draft_head_bits)
            draft = type(target)(
                dparams, _clone_cfg(base_cfg, num_hidden_layers=d),
                max_batch=target.max_batch, max_len=target.max_len,
                dtype=target.dtype,
                kv_dtype="int8" if target.kv_int8 else "native",
                spec=target.spec, auto_grow=target.auto_grow,
                grow_limit=target.grow_limit, device=target.device)
        self.draft = draft
        # proposals made and accepted (speed diagnostics)
        self.proposed = 0
        self.accepted = 0
        # the sampling mode's acceptance tests and residual draws
        self._host_rng = np.random.default_rng(0)

    # ------------------------------------------------------------------
    def add_request(self, tokens, **kw) -> int:
        """Prefill both engines; returns the (shared) slot id."""
        slot = self.target.add_request(tokens, **kw)
        dslot = self.draft.add_request(tokens, **kw)
        if dslot != slot:
            raise RuntimeError(
                "target/draft slot allocation diverged: add and release "
                f"requests through the SpecDecoder only ({slot} vs {dslot})")
        return slot

    def release(self, slot: int):
        self.target.release(slot)
        self.draft.release(slot)

    @property
    def lengths(self):
        return self.target.lengths

    def _pending(self, slot: int) -> int:
        return self.target._pending_next[slot]

    def _require_greedy(self, last_tokens):
        t = self.target
        if any(t.temps[s] > 0 for s in last_tokens):
            raise ValueError(
                "this is the GREEDY spec-decode path (argmax-equality "
                "acceptance); slots with temperature > 0 must go through "
                "sample_spec_step / generate(temperature=...) instead")

    def _count(self, n_emitted: int):
        self.proposed += self.gamma
        self.accepted += n_emitted - 1

    # ------------------------------------------------------------------
    def spec_step(self, last_tokens: Dict[int, int]) -> Dict[int, List[int]]:
        """One round for the given slots ({slot: last emitted token}):
        spec_steps(last_tokens, rounds=1). (The JAX package keeps a
        host-paced round for its tensor-parallel engines, which the port
        does not have yet.) Returns {slot: [1..gamma + 1 tokens]}."""
        return self.spec_steps(last_tokens, rounds=1)

    # ------------------------------------------------------------------
    def _rounds(self, last, lengths, rounds: int, kv_len: int):
        """``rounds`` greedy rounds, every tensor on the device and no host
        synchronisation: per round, gamma + 1 draft decode steps and their
        argmaxes, one verify pass of the target over [last, p_1..p_gamma],
        the accepted count from a cumulative product of matches, and the
        next last tokens and lengths. Returns the (rounds, B, gamma + 1)
        verify argmaxes and the (rounds, B) emitted counts."""
        g, t, d = self.gamma, self.target, self.draft
        outs, n_emits = [], []
        for _ in range(rounds):
            toks, dlens, props = last, lengths, []
            for _ in range(g + 1):
                toks = d._select(d._decode_impl(toks, dlens, kv_len),
                                 None, None, None, False)
                dlens = dlens + 1
                props.append(toks)
            props = torch.stack(props[:g], dim=1)             # (B, g)
            out = t._verify_impl(torch.cat([last[:, None], props], dim=1),
                                 lengths, kv_len, False)      # (B, g + 1)
            match = (out[:, :g] == props).to(torch.int32)
            n_emit = 1 + torch.cumprod(match, dim=1).sum(dim=1,
                                                         dtype=torch.int32)
            last = torch.gather(out, 1, (n_emit - 1).long()[:, None])[:, 0]
            lengths = lengths + n_emit
            outs.append(out)
            n_emits.append(n_emit)
        return torch.stack(outs), torch.stack(n_emits)

    def spec_steps(self, last_tokens: Dict[int, int],
                   rounds: int = 4) -> Dict[int, List[int]]:
        """``rounds`` greedy rounds in one dispatch (``_rounds``), the fused
        counterpart of JAX's spec_step as step_n is of step. The window
        bucket is
        set once for the dispatch, on the host, from the worst case of
        rounds x (gamma + 1) new rows. Returns {slot: [tokens]}."""
        g, t, d = self.gamma, self.target, self.draft
        self._require_greedy(last_tokens)
        need = rounds * (g + 1)
        t._check_capacity(last_tokens, need)
        d._check_capacity(last_tokens, need)
        for s in last_tokens:
            d.lengths[s] = t.lengths[s]
        toks, lengths = t._device_tokens(last_tokens)
        outs, n_emits = self._rounds(toks, lengths, rounds,
                                     t._kv_len(need + 1))
        outs = outs.cpu().numpy()        # (r, B, g + 1)
        n_emits = n_emits.cpu().numpy()  # (r, B)
        res = {s: [] for s in last_tokens}
        for rd in range(rounds):
            for s in last_tokens:
                n = int(n_emits[rd, s])
                res[s].extend(outs[rd, s, :n].tolist())
                t.lengths[s] += n
                self._count(n)
        for s in last_tokens:
            d.lengths[s] = t.lengths[s]
        return res

    # ------------------------------------------------------------------
    def sample_spec_step(self, last_tokens: Dict[int, int]
                         ) -> Dict[int, List[int]]:
        """One SAMPLING round (rejection-sampling acceptance, Leviathan et
        al. 2022): the draft samples gamma proposals from q_i with its own
        generator, the target scores them in one verify pass, and proposal
        x_i is accepted with probability min(1, p_i(x_i) / q_i(x_i)); the
        first rejection is replaced by a draw from normalize(max(p_i - q_i,
        0)) and ends the round; full acceptance adds a draw from p_gamma.
        The emitted stream is distributed as target sampling at the slot's
        temperature (up to the difference between the decode pass that
        proposes and the verify pass that scores, in low-order bits).
        Temperature-only: every slot needs temperature > 0, top_k 0 and
        top_p 1."""
        g, t, d = self.gamma, self.target, self.draft
        for s in last_tokens:
            if not t.temps[s] > 0:
                raise ValueError(
                    "sample_spec_step needs temperature > 0 for every "
                    f"requested slot (slot {s} is greedy — use spec_step)")
            if t.top_ks[s] != 0 or t.top_ps[s] != 1.0:
                raise ValueError(
                    "sampling-mode speculative decoding supports "
                    "temperature-only warping (top_k=0, top_p=1); slot "
                    f"{s} has top_k={t.top_ks[s]}, top_p={t.top_ps[s]}")
        t._check_capacity(last_tokens, g + 1)
        d._check_capacity(last_tokens, g + 1)
        for s in last_tokens:
            d.lengths[s] = t.lengths[s]
        props = {s: [] for s in last_tokens}
        cur = dict(last_tokens)
        for _ in range(g):
            cur = d.step(cur)
            for s in last_tokens:
                props[s].append(cur[s])
        for s in last_tokens:  # step() advanced; verify re-scores from L
            d.lengths[s] = t.lengths[s]
        ver = {s: [last_tokens[s]] + props[s] for s in last_tokens}
        q_log = d.verify_step_logits(ver)
        p_log = t.verify_step_logits(ver)
        rng = self._host_rng
        res: Dict[int, List[int]] = {}
        for s in last_tokens:
            T = float(t.temps[s])
            p = _softmax_rows(p_log[s] / T)   # (g + 1, V)
            q = _softmax_rows(q_log[s] / T)
            emitted: List[int] = []
            for i in range(g):
                x = props[s][i]
                if rng.uniform() < min(1.0, p[i, x] / max(q[i, x], 1e-30)):
                    emitted.append(x)
                    continue
                resid = np.maximum(p[i] - q[i], 0.0)
                tot = resid.sum()
                if tot <= 0:  # p == q: the residual is empty, draw from p
                    resid, tot = p[i], p[i].sum()
                emitted.append(int(rng.choice(len(resid), p=resid / tot)))
                break
            else:  # all gamma accepted: a bonus draw from p_gamma
                emitted.append(int(rng.choice(p.shape[1],
                                              p=p[g] / p[g].sum())))
            t.lengths[s] += len(emitted)
            self._count(len(emitted))
            res[s] = emitted
        for s in last_tokens:
            d.lengths[s] = t.lengths[s]
        return res

    def _step_one(self, slot: int, last: int) -> int:
        """One plain target step, for when a round no longer fits."""
        tok = self.target.step({slot: last})[slot]
        self.draft.lengths[slot] = self.target.lengths[slot]
        return tok

    def generate(self, prompt_tokens, max_new_tokens: int = 32,
                 rounds_per_dispatch: int = 4,
                 temperature: float = 0.0) -> list:
        """Greedy (temperature 0): the tokens of target.generate(
        prompt_tokens, max_new_tokens). With temperature > 0, speculative
        sampling (sample_spec_step). Without auto_grow, near max_len the
        dispatch shrinks to the rounds that fit, and once none fits the
        stream ends with plain steps (which need one row each)."""
        t, g = self.target, self.gamma
        if temperature > 0:
            slot = self.add_request(list(prompt_tokens),
                                    temperature=temperature)
            out = [self._pending(slot)]
            while len(out) < max_new_tokens:
                head = t.max_len - int(t.lengths[slot])
                if not t.auto_grow and head < g + 1:
                    out.append(self._step_one(slot, out[-1]))
                    continue
                out.extend(self.sample_spec_step({slot: out[-1]})[slot])
            self.release(slot)
            return out[:max_new_tokens]
        slot = self.add_request(prompt_tokens)
        out = [self._pending(slot)]
        while len(out) < max_new_tokens:
            room = max_new_tokens - len(out)
            r = max(1, min(rounds_per_dispatch, -(-room // (g + 1))))
            if not t.auto_grow:
                r_fit = (t.max_len - int(t.lengths[slot])) // (g + 1)
                if r_fit == 0:
                    out.append(self._step_one(slot, out[-1]))
                    continue
                r = min(r, r_fit)
            out.extend(self.spec_steps({slot: out[-1]}, rounds=r)[slot])
        self.release(slot)
        return out[:max_new_tokens]

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def _softmax_rows(logits: np.ndarray) -> np.ndarray:
    """Row-wise float64 softmax (the acceptance ratios and residual
    distributions want full precision)."""
    z = logits.astype(np.float64)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def _clone_cfg(cfg, **overrides):
    """A copy of a dataclass config, or of a plain attribute namespace, with
    ``overrides``."""
    if dataclasses.is_dataclass(cfg):
        return dataclasses.replace(cfg, **overrides)
    return SimpleNamespace(**{**vars(cfg), **overrides})
