"""Single-device serving engine with slot-based continuous batching and a
bf16 (native-dtype) KV cache.

Counterpart of ``omniquant_tpu/serving/engine.py::LlamaEngine``. PyTorch
runs eagerly, so the jitted step programs become plain methods; the
bucketing of prompt lengths and attention windows is kept so the port
computes on the same shapes as the reference. Weights may be dense or
PackedWeight (``models.common.linear``); the cache is updated IN PLACE by
the kv_update kernels (the JAX engine donates and aliases its buffers). The
CUDA kernels take bf16, so an engine on the card runs at the default
``dtype=torch.bfloat16``; other dtypes run on the CPU.

Not in this slice: ``kv_dtype="int8"``, ``auto_grow`` and ``verify_step*``
raise NotImplementedError; ``prefetch_grow`` and the AOT tables only hid XLA
compiles and have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.kv_update import kv_cache_prefill_write, kv_cache_write
from ..models import llama as tllama
from ..models.common import (
    NO_ACT_QUANT, ActQuantSpec, linear, maybe_quant, repeat_kv, rms_norm)
from ..quant.packing import PackedWeight
from .sampling import sample_tokens


def fuse_packed(pws: List[PackedWeight]) -> Optional[PackedWeight]:
    """Concatenate packed linears that share in_features into one (qkv,
    gate+up): qweight columns and scale/zero rows concatenate along out.
    None when they cannot be fused."""
    if not all(isinstance(p, PackedWeight) for p in pws):
        return None
    first = pws[0]
    if not all(
        p.bits == first.bits and p.group_size == first.group_size
        and p.in_features == first.in_features and p.tile_k == first.tile_k
        and p.layout == first.layout
        and p.qweight.shape[0] == first.qweight.shape[0]
        for p in pws
    ):
        return None
    bias = None
    if any(p.bias is not None for p in pws):
        bias = torch.cat([
            p.bias if p.bias is not None else torch.zeros(
                p.out_features, dtype=torch.float32, device=p.qweight.device)
            for p in pws])
    return PackedWeight(
        qweight=torch.cat([p.qweight for p in pws], dim=1),
        scales=torch.cat([p.scales for p in pws], dim=0),
        zeros=torch.cat([p.zeros for p in pws], dim=0),
        bias=bias, bits=first.bits, group_size=first.group_size,
        in_features=first.in_features,
        out_features=sum(p.out_features for p in pws),
        tile_k=first.tile_k, layout=first.layout)


@dataclasses.dataclass
class KVCache:
    """Per-layer lists of (B, n_kv, max_len, hd) tensors, written in place."""

    k: list
    v: list


def _pow2_bucket(n: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(n))))


class LlamaEngine:
    """Continuous-batching decoder for the llama family."""

    def __init__(self, params: dict, cfg: tllama.LlamaConfig,
                 max_batch: int = 8, max_len: int = 2048,
                 dtype=torch.bfloat16, kv_dtype: str = "native",
                 spec: ActQuantSpec = NO_ACT_QUANT, seed: int = 0,
                 flash_min_len: int = 256, auto_grow: bool = False,
                 device="cuda"):
        if kv_dtype != "native":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: only the native-dtype KV cache is "
                "ported so far")
        if auto_grow:
            raise NotImplementedError("auto_grow is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.dtype = dtype
        # a non-identity softmax-probs quantizer cannot be honoured inside
        # the flash kernel (probabilities never materialise)
        self._p_quant_active = spec.p is not None and spec.p.enabled
        self.flash_min_len = flash_min_len
        self.spec = spec
        self.params = self._prep_params(params)
        self.cache = self._init_cache()

        # host-side slot state
        self.lengths = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ks = np.zeros(max_batch, np.int32)
        self.top_ps = np.ones(max_batch, np.float32)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._pending_next = {}

    # ------------------------------------------------------------------
    def _prep_params(self, params: dict) -> dict:
        """Move to the device, cast floating tensors to the engine dtype
        (PackedWeight scales, zeros and bias included, as the JAX engine
        does: a bf16 engine serves bf16-rounded scales) and fuse the packed
        qkv and gate+up projections."""
        def prep(x):
            if isinstance(x, PackedWeight):
                return x.map_tensors(prep)
            if isinstance(x, torch.Tensor):
                x = x.to(self.device)
                return x.to(self.dtype) if x.is_floating_point() else x
            if isinstance(x, dict):
                return {k: prep(v) for k, v in x.items()}
            if isinstance(x, list):
                return [prep(v) for v in x]
            return x

        params = prep(params)
        for p in params["layers"]:
            qkv = fuse_packed([p["q_proj"], p["k_proj"], p["v_proj"]])
            if qkv is not None:
                p["qkv_fused"] = qkv
                del p["q_proj"], p["k_proj"], p["v_proj"]
            gu = fuse_packed([p["gate_proj"], p["up_proj"]])
            if gu is not None:
                p["gate_up_fused"] = gu
                del p["gate_proj"], p["up_proj"]
        return params

    def _init_cache(self) -> KVCache:
        L = self.cfg.num_hidden_layers
        shape = (self.max_batch, self.cfg.num_key_value_heads, self.max_len,
                 self.cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return KVCache([zeros() for _ in range(L)], [zeros() for _ in range(L)])

    def _flash_ok(self) -> bool:
        return not self._p_quant_active

    def _alibi_slopes(self):
        return None

    def _do_sample(self) -> bool:
        return bool(np.any(self.temps[self.active] > 0.0))

    def _select(self, logits, temps, top_ks, top_ps, do_sample: bool):
        """(B, V) logits -> (B,) int32 next tokens."""
        if not do_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_tokens(logits, self._generator, temps, top_ks, top_ps)

    def _controls(self, idx):
        """Per-slot sampling controls as device tensors."""
        dev = self.device
        return (torch.as_tensor(self.temps[idx], device=dev),
                torch.as_tensor(self.top_ks[idx], device=dev),
                torch.as_tensor(self.top_ps[idx], device=dev))

    # ------------------------------------------------------------------
    def _write_kv(self, cache: KVCache, li, slot, pos, k_new, v_new):
        """Write (n_kv, s, hd) k/v into cache layer li at (slot, pos=0)."""
        del pos  # always 0: prefill writes the sequence head
        slots = torch.full((1,), slot, dtype=torch.int32, device=self.device)
        kv_cache_prefill_write(cache.k[li], k_new[None].to(self.dtype), slots)
        kv_cache_prefill_write(cache.v[li], v_new[None].to(self.dtype), slots)

    def _read_kv(self, cache: KVCache, li, kv_len: Optional[int] = None):
        """-> (B, n_kv, kv_len, hd) views of the cache window."""
        sl = slice(None) if kv_len is None else slice(0, kv_len)
        return cache.k[li][:, :, sl], cache.v[li][:, :, sl]

    # ------------------------------------------------------------------
    # family hooks
    def _embed(self, params, tokens, positions):
        return tllama.embed(params, tokens).to(self.dtype)

    def _head(self, params, x):
        return tllama.head(params, x, self.cfg)

    def _attn_norm(self, p, x):
        return rms_norm(x, p["input_layernorm"], self.cfg.rms_norm_eps)

    def _attn_out(self, p, attn):
        return linear(attn, p["o_proj"], self.spec.act)

    def _attn_qkv(self, p, hidden, positions):
        cfg = self.cfg
        b, s, _ = hidden.shape
        q_dim = cfg.num_attention_heads * cfg.head_dim
        kv_dim = cfg.num_key_value_heads * cfg.head_dim
        if "qkv_fused" in p:
            qkv = linear(hidden, p["qkv_fused"], self.spec.act)
            q = qkv[..., :q_dim]
            k = qkv[..., q_dim: q_dim + kv_dim]
            v = qkv[..., q_dim + kv_dim:]
        else:
            q = linear(hidden, p["q_proj"], self.spec.act)
            k = linear(hidden, p["k_proj"], self.spec.act)
            v = linear(hidden, p["v_proj"], self.spec.act)

        def heads(y, n):
            return y.reshape(b, s, n, cfg.head_dim).transpose(1, 2)

        q = heads(q, cfg.num_attention_heads)
        k = heads(k, cfg.num_key_value_heads)
        v = heads(v, cfg.num_key_value_heads)
        cos, sin = tllama.rope_cos_sin(
            positions, cfg.head_dim, cfg.rope_theta, dtype=hidden.dtype)
        q, k = tllama.apply_rope(q, k, cos, sin)
        return q, k, v

    def _mlp(self, p, x):
        h = rms_norm(x, p["post_attention_layernorm"], self.cfg.rms_norm_eps)
        if "gate_up_fused" in p:
            gu = linear(h, p["gate_up_fused"], self.spec.act)
            i = self.cfg.intermediate_size
            gate, up = gu[..., :i], gu[..., i:]
        else:
            gate = linear(h, p["gate_proj"], self.spec.act)
            up = linear(h, p["up_proj"], self.spec.act)
        act = torch.nn.functional.silu(gate) * up
        return x + linear(act, p["down_proj"], self.spec.act)

    def _quant_qkv(self, q, k, v):
        """The spec's q/k/v activation quantizers, applied before the cache
        commit (per-token quant: quantize-once-at-write equals the eval
        path's quantize-at-every-attend)."""
        return (maybe_quant(q, self.spec.q), maybe_quant(k, self.spec.k),
                maybe_quant(v, self.spec.v))

    def _sm_scale(self) -> float:
        return float(self.cfg.head_dim) ** -0.5

    def _attn_core(self, p, hidden, positions, mask, commit):
        """qkv -> cache commit -> attention -> output projection."""
        b, s, _ = hidden.shape
        q, k, v = self._attn_qkv(p, hidden, positions)
        q, k, v = self._quant_qkv(q, k, v)
        k_all, v_all = commit(k, v)
        if (s >= max(2, self.flash_min_len) and k_all.shape[2] == s
                and self._flash_ok()):
            # prefill of fresh same-length k/v under a plain causal mask:
            # the blockwise kernel never materialises the (s, s) scores
            attn = flash_attention(q, k_all, v_all, sm_scale=self._sm_scale(),
                                   causal=True,
                                   alibi_slopes=self._alibi_slopes())
            return self._attn_out(p, attn.transpose(1, 2).reshape(b, s, -1))
        k_r = repeat_kv(k_all, self.cfg.n_rep)
        v_r = repeat_kv(v_all, self.cfg.n_rep)
        scores = torch.matmul(q, k_r.transpose(-1, -2)) * self._sm_scale()
        probs = torch.softmax((scores + mask).float(), dim=-1).to(self.dtype)
        probs = maybe_quant(probs, self.spec.p)
        attn = torch.matmul(probs, v_r)
        return self._attn_out(p, attn.transpose(1, 2).reshape(b, s, -1))

    def _block(self, p, x, positions, mask, commit):
        residual = x
        hidden = self._attn_norm(p, x)
        x = residual + self._attn_core(p, hidden, positions, mask, commit)
        return self._mlp(p, x)

    # ------------------------------------------------------------------
    def _prefill_mask(self, seq_len: int):
        positions = torch.arange(seq_len, device=self.device)
        neg = torch.finfo(self.dtype).min
        mask = torch.where(positions[None, :] <= positions[:, None], 0.0, neg)
        return positions, mask.to(self.dtype)[None, None]

    def _prefill_impl(self, tokens, slot: int, last_idx: int, seq_len: int):
        """Prefill one slot with ``tokens`` (1, seq_len), bucket-padded;
        returns the (1, V) logits at ``last_idx``."""
        positions, mask = self._prefill_mask(seq_len)
        x = self._embed(self.params, tokens, positions[None])
        for li, p in enumerate(self.params["layers"]):
            def commit(k, v, _li=li):
                self._write_kv(self.cache, _li, slot, 0, k[0], v[0])
                return k, v
            x = self._block(p, x, positions, mask, commit)
        return self._head(self.params, x[:, last_idx: last_idx + 1])[:, 0]

    def _prefill_multi_impl(self, tokens, slots, last_idx, seq_len: int):
        """Prefill N requests at once: tokens (N, seq_len) padded to a common
        bucket, slots (N,) target slots, last_idx (N,) each prompt's final
        position. Returns the (N, V) logits at last_idx."""
        positions, mask = self._prefill_mask(seq_len)
        x = self._embed(self.params, tokens, positions[None])
        for li, p in enumerate(self.params["layers"]):
            def commit(k, v, _li=li):
                kv_cache_prefill_write(self.cache.k[_li], k.to(self.dtype), slots)
                kv_cache_prefill_write(self.cache.v[_li], v.to(self.dtype), slots)
                return k, v
            x = self._block(p, x, positions, mask, commit)
        idx = last_idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
        return self._head(self.params, torch.gather(x, 1, idx))[:, 0]

    def _decode_impl(self, last_tokens, lengths, kv_len: int):
        """One decode step for all slots: last_tokens (B,), lengths (B,)
        tokens already cached. Attention reads the cache window [0, kv_len)
        (the caller buckets it). Returns the (B, V) logits."""
        positions = lengths[:, None]
        x = self._embed(self.params, last_tokens[:, None], positions)
        kv_positions = torch.arange(kv_len, device=self.device)
        neg = torch.finfo(self.dtype).min
        mask = torch.where(kv_positions[None, :] <= lengths[:, None], 0.0, neg)
        mask = mask.to(self.dtype)[:, None, None, :]
        for li, p in enumerate(self.params["layers"]):
            def commit(k, v, _li=li):
                kv_cache_write((self.cache.k[_li], self.cache.v[_li]),
                               (k[:, :, 0].to(self.dtype),
                                v[:, :, 0].to(self.dtype)), lengths)
                return self._read_kv(self.cache, _li, kv_len)
            x = self._block(p, x, positions, mask, commit)
        return self._head(self.params, x)[:, 0]

    def _decode_multi_impl(self, last_tokens, lengths, kv_len: int,
                           n_steps: int, do_sample: bool):
        """n_steps decode steps with no host round trip; (B, n_steps)."""
        controls = self._controls(slice(None)) if do_sample else (None,) * 3
        toks, lens, outs = last_tokens, lengths, []
        for _ in range(n_steps):
            logits = self._decode_impl(toks, lens, kv_len)
            toks = self._select(logits, *controls, do_sample)
            lens = lens + 1
            outs.append(toks)
        return torch.stack(outs, dim=1)

    # ------------------------------------------------------------------
    # host-side continuous batching API
    def add_request(self, tokens, temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0) -> int:
        """Prefill ``tokens`` into a free slot; returns the slot id.
        temperature <= 0 is greedy; top_k 0 and top_p 1.0 disable filters."""
        free = np.where(~self.active)[0]
        if len(free) == 0:
            raise RuntimeError("no free slots")
        slot = int(free[0])
        self.temps[slot] = temperature
        self.top_ks[slot] = top_k
        self.top_ps[slot] = top_p
        t = np.asarray(tokens, np.int32)
        bucket = _pow2_bucket(len(t), 16)
        self._ensure_prefill_capacity(bucket)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(t)] = t
        logits = self._prefill_impl(
            torch.as_tensor(padded, device=self.device), slot, len(t) - 1,
            seq_len=bucket)
        first = self._select(logits, *self._controls(slice(slot, slot + 1)),
                             temperature > 0.0)
        self.active[slot] = True
        self.lengths[slot] = len(t)
        self._pending_next[slot] = int(first[0])
        return slot

    def add_requests(self, requests, temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, return_logits: bool = False):
        """Prefill several prompts in one batched pass. All prompts share the
        power-of-two bucket of the longest; pads are never attended. Returns
        the slot ids (and, with return_logits, the (N, V) logits each first
        token was chosen from); first tokens land in ``_pending_next``."""
        free = np.where(~self.active)[0]
        if len(free) < len(requests):
            raise RuntimeError(
                f"need {len(requests)} free slots, have {len(free)}")
        slots = free[: len(requests)].astype(np.int32)
        bucket = _pow2_bucket(max(len(r) for r in requests), 16)
        self._ensure_prefill_capacity(bucket)
        toks = np.zeros((len(requests), bucket), np.int32)
        last_idx = np.zeros(len(requests), np.int32)
        for i, r in enumerate(requests):
            toks[i, : len(r)] = np.asarray(r, np.int32)
            last_idx[i] = len(r) - 1
        self.temps[slots] = temperature
        self.top_ks[slots] = top_k
        self.top_ps[slots] = top_p
        dev = self.device
        logits = self._prefill_multi_impl(
            torch.as_tensor(toks, device=dev), torch.as_tensor(slots, device=dev),
            torch.as_tensor(last_idx, device=dev), seq_len=bucket)
        first = self._select(logits, *self._controls(slots), temperature > 0.0)
        first = first.cpu().numpy()
        for i, s in enumerate(slots):
            self.active[s] = True
            self.lengths[s] = len(requests[i])
            self._pending_next[int(s)] = int(first[i])
        slot_ids = [int(s) for s in slots]
        return (slot_ids, logits) if return_logits else slot_ids

    def release(self, slot: int):
        self.active[slot] = False
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 1.0

    def _check_capacity(self, slots, n: int):
        """Refuse a decode whose write position would reach max_len, for
        every active slot as well as the requested ones (a step writes a row
        for every slot). The CUDA write drops such a row rather than
        clamping it, but the slot's history would still be cut short."""
        check = set(int(s) for s in np.nonzero(self.active)[0])
        check.update(int(s) for s in slots)
        over = [s for s in sorted(check) if self.lengths[s] + n > self.max_len]
        if over:
            raise RuntimeError(
                f"slots {over} would exceed max_len={self.max_len} after "
                f"{n} step(s) (lengths {[int(self.lengths[s]) for s in over]});"
                " release them or build the engine with a larger max_len")

    def _ensure_prefill_capacity(self, bucket: int):
        if bucket > self.max_len:
            raise RuntimeError(
                f"prompt bucket {bucket} exceeds max_len={self.max_len}; "
                "build the engine with a larger max_len")

    def _kv_len(self, extra: int) -> int:
        """Attention window: the power of two above the longest live
        sequence plus the tokens this dispatch writes, at least 64."""
        longest = int(self.lengths[self.active].max()) if self.active.any() else 0
        return min(self.max_len, _pow2_bucket(longest + extra, 64))

    def _device_tokens(self, last_tokens: dict):
        toks = np.zeros(self.max_batch, np.int32)
        for s, t in last_tokens.items():
            toks[s] = t
        dev = self.device
        return (torch.as_tensor(toks, device=dev),
                torch.as_tensor(self.lengths, device=dev))

    def step(self, last_tokens: dict) -> dict:
        """One decode step. last_tokens: {slot: token}. Returns
        {slot: next token} for those slots."""
        self._check_capacity(last_tokens, 1)
        toks, lengths = self._device_tokens(last_tokens)
        do_sample = self._do_sample()
        controls = self._controls(slice(None)) if do_sample else (None,) * 3
        logits = self._decode_impl(toks, lengths, self._kv_len(1))
        next_tokens = self._select(logits, *controls, do_sample).cpu().numpy()
        out = {}
        for s in last_tokens:
            self.lengths[s] += 1
            out[s] = int(next_tokens[s])
        return out

    def step_n(self, last_tokens: dict, n: int) -> dict:
        """n decode steps in one dispatch. Returns {slot: [n tokens]}."""
        self._check_capacity(last_tokens, n)
        toks, lengths = self._device_tokens(last_tokens)
        out = self._decode_multi_impl(
            toks, lengths, self._kv_len(n + 1), n, self._do_sample())
        out = out.cpu().numpy()
        res = {}
        for s in last_tokens:
            self.lengths[s] += n
            res[s] = out[s].tolist()
        return res

    def verify_step(self, tokens: dict) -> dict:
        raise NotImplementedError("speculative-decoding verify is not ported yet")

    def verify_step_logits(self, tokens: dict) -> dict:
        raise NotImplementedError("speculative-decoding verify is not ported yet")

    def generate(self, prompt_tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> list:
        """Single-request convenience wrapper (greedy by default)."""
        slot = self.add_request(prompt_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p)
        next_tok = self._pending_next[slot]
        out = [next_tok]
        for _ in range(max_new_tokens - 1):
            next_tok = self.step({slot: next_tok})[slot]
            out.append(next_tok)
        self.release(slot)
        return out
