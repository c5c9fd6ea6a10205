"""Single-device serving engine with slot-based continuous batching and a
native-dtype or int8 KV cache.

Counterpart of ``omniquant_tpu/serving/engine.py::LlamaEngine`` and its
``OPTEngine`` and ``FalconEngine`` (subclasses that override the family
hooks). PyTorch runs eagerly, so the jitted step programs become plain
methods; the bucketing of prompt lengths and attention windows is kept so
the port computes on the same shapes as the reference. Weights may be dense or
PackedWeight (``models.common.linear``). With an activation spec
(``ActQuantSpec.from_bits(4)`` or ``(6)``: W4A4, W6A6) every packed linear,
the fused qkv and gate+up included, takes the integer path
(``quant_matmul_int``), and q/k/v are fake-quantized before the cache
commit; from_bits' 16-bit softmax quantizer is the identity, so the flash
and fused attention paths stay on. The cache is updated IN PLACE by
the kv_update kernels (the JAX engine donates and aliases its buffers). The
CUDA kernels take bf16, so an engine on the card runs at the default
``dtype=torch.bfloat16``; other dtypes run on the CPU.

``kv_dtype="int8"`` stores per-token symmetric int8 codes with f32 scale
planes (B, n_kv, max_len). Its decode attention (``attn_kernel``, on by
default) reads the codes through ``decode_attention_int8``, and ``step_n``
then stages each step's k/v in small per-layer rings that the kernel
attends, flushing them with one span write per layer at the end. The
speculative-decoding verify pass (``verify_step``, ``verify_step_logits``)
serves both cache dtypes; ``spec_decode.SpecDecoder`` drives it.

``auto_grow=True`` lets the cache grow: a slot that would write past
``max_len`` (a decode, a verify, a prompt longer than the cache) doubles
it, up to ``grow_limit``, copying the live codes or rows (and an int8
cache's scale planes) into new buffers. The JAX engine's ``prefetch_grow``,
its AOT tables and ``_seen_steps`` only hid XLA compiles of the grown
shapes and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels.decode_attention import decode_attention_int8
from ..kernels.flash_attention import flash_attention
from ..kernels.kv_update import (
    kv_cache_prefill_write, kv_cache_write, kv_cache_write_span,
    scale_plane_init)
from ..models import falcon as tfalcon
from ..models import llama as tllama
from ..models import opt as topt
from ..models.common import (
    NO_ACT_QUANT, ActQuantSpec, layer_norm, linear, maybe_quant, repeat_kv,
    rms_norm)
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
    """Per-layer lists of (B, n_kv, max_len, hd) tensors, written in place;
    with an int8 cache also per-layer (B, n_kv, max_len) f32 scale planes."""

    k: list
    v: list
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None


@dataclasses.dataclass
class _Int8Window:
    """What an int8 commit hands to the fused decode attention: the full
    cache buffers of one layer, the window bound, the per-slot last
    attended position, and optionally the ring of staged tokens."""

    kv_len: int
    k: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor
    ring: Optional[Tuple[torch.Tensor, ...]] = None
    ring_n: int = -1


def _quantize_kv(x: torch.Tensor):
    """Per-token symmetric int8 quantization over head_dim, computed in
    x's dtype as the JAX engine does; returns (int8 codes, f32 scales with
    a trailing 1)."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.float()


def _to_engine(x, device, dtype):
    """A parameter tree on ``device`` with its floating tensors in ``dtype``.
    A module-level function: a nested recursive one closing over the engine
    would form a reference cycle that keeps a deleted engine, and its KV
    cache, alive until the cyclic garbage collector runs."""
    if isinstance(x, PackedWeight):
        return x.map_tensors(lambda t: _to_engine(t, device, dtype))
    if isinstance(x, torch.Tensor):
        x = x.to(device)
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _to_engine(v, device, dtype) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_engine(v, device, dtype) for v in x]
    return x


def _pow2_bucket(n: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(n))))


class LlamaEngine:
    """Continuous-batching decoder for the llama family."""

    def __init__(self, params: dict, cfg: tllama.LlamaConfig,
                 max_batch: int = 8, max_len: int = 2048,
                 dtype=torch.bfloat16, kv_dtype: str = "native",
                 spec: ActQuantSpec = NO_ACT_QUANT,
                 attn_kernel: Optional[bool] = None, seed: int = 0,
                 flash_min_len: int = 256, auto_grow: bool = False,
                 grow_limit: Optional[int] = None, device="cuda"):
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', not "
                             f"{kv_dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        # a growing cache doubles instead of refusing a slot that would
        # outrun max_len, up to the model's positions (else 16 x max_len)
        self.auto_grow = auto_grow
        self.grow_limit = grow_limit or getattr(
            cfg, "max_position_embeddings", 0) or (max_len * 16)
        self.dtype = dtype
        self.kv_int8 = kv_dtype == "int8"
        # a non-identity softmax-probs quantizer cannot be honoured inside
        # the fused kernels (probabilities never materialise)
        self._p_quant_active = spec.p is not None and spec.p.enabled
        # the fused int8 decode attention: on by default for int8 caches
        self.attn_kernel = ((True if attn_kernel is None else attn_kernel)
                            and self.kv_int8 and not self._p_quant_active)
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
        qkv and gate+up projections. A layer that already holds a fused
        projection (another engine's params, e.g. a layer-skip draft that
        shares its target's buffers) is left as it is: ``_to_engine``
        returns its tensors themselves when device and dtype match."""
        params = _to_engine(params, self.device, self.dtype)
        for p in params["layers"]:
            if "qkv_fused" in p or "gate_up_fused" in p:
                continue
            qkv = (fuse_packed([p["q_proj"], p["k_proj"], p["v_proj"]])
                   if "q_proj" in p else None)
            if qkv is not None:
                p["qkv_fused"] = qkv
                del p["q_proj"], p["k_proj"], p["v_proj"]
            gu = (fuse_packed([p["gate_proj"], p["up_proj"]])
                  if "gate_proj" in p else None)
            if gu is not None:
                p["gate_up_fused"] = gu
                del p["gate_proj"], p["up_proj"]
        return params

    def _init_cache(self) -> KVCache:
        L = self.cfg.num_hidden_layers
        shape = (self.max_batch, self.cfg.num_key_value_heads, self.max_len,
                 self.cfg.head_dim)
        kv_type = torch.int8 if self.kv_int8 else self.dtype

        def zeros():
            return torch.zeros(shape, dtype=kv_type, device=self.device)

        cache = KVCache([zeros() for _ in range(L)], [zeros() for _ in range(L)])
        if self.kv_int8:
            def plane():
                return scale_plane_init(*shape[:3], device=self.device)

            cache.k_scale = [plane() for _ in range(L)]
            cache.v_scale = [plane() for _ in range(L)]
        return cache

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
    @staticmethod
    def _set_plane(plane, slots, scales, seq_len: int):
        """Write (N, n_kv, seq, 1) scales into a (B, n_kv, max_len) plane at
        positions [0, seq) of each slot (the prefill commit of the scales)."""
        plane[slots.long(), :, :seq_len] = scales[..., 0]

    def _commit_prefill(self, cache: KVCache, li, slots, k, v):
        """Write (N, n_kv, s, hd) prefilled k/v at positions [0, s) of each
        slot; an int8 cache stores their codes and scales."""
        if not self.kv_int8:
            kv_cache_prefill_write(cache.k[li], k.to(self.dtype), slots)
            kv_cache_prefill_write(cache.v[li], v.to(self.dtype), slots)
            return
        kc, ks = _quantize_kv(k)
        vc, vs = _quantize_kv(v)
        kv_cache_prefill_write(cache.k[li], kc, slots)
        kv_cache_prefill_write(cache.v[li], vc, slots)
        self._set_plane(cache.k_scale[li], slots, ks, k.shape[2])
        self._set_plane(cache.v_scale[li], slots, vs, v.shape[2])

    def _layer_bufs(self, cache: KVCache, li) -> tuple:
        """The buffers a decode write or span flush of layer li covers: K
        and V, then (int8) their scale planes."""
        if self.kv_int8:
            return (cache.k[li], cache.v[li], cache.k_scale[li],
                    cache.v_scale[li])
        return cache.k[li], cache.v[li]

    def _rows(self, k, v) -> tuple:
        """New k/v rows (B, n_kv, [span,] hd) as the cache stores them, in
        the order of ``_layer_bufs``."""
        if self.kv_int8:
            kc, ks = _quantize_kv(k)
            vc, vs = _quantize_kv(v)
            return kc, vc, ks[..., 0], vs[..., 0]
        return k.to(self.dtype), v.to(self.dtype)

    def _window(self, li, kv_len: int, lengths, ring=None,
                ring_n: int = -1) -> _Int8Window:
        c = self.cache
        return _Int8Window(kv_len, c.k[li], c.k_scale[li], c.v[li],
                           c.v_scale[li], lengths, ring, ring_n)

    def _read_kv(self, cache: KVCache, li, kv_len: Optional[int] = None):
        """-> (B, n_kv, kv_len, hd) of the cache window, dequantized in the
        engine dtype for an int8 cache."""
        sl = slice(None) if kv_len is None else slice(0, kv_len)
        if self.kv_int8:
            ks = cache.k_scale[li][:, :, sl, None].to(self.dtype)
            vs = cache.v_scale[li][:, :, sl, None].to(self.dtype)
            return (cache.k[li][:, :, sl].to(self.dtype) * ks,
                    cache.v[li][:, :, sl].to(self.dtype) * vs)
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
        return self._out_linear(attn, p["o_proj"])

    def _out_linear(self, x, w):
        """The linears whose input is split over the heads or the
        intermediate under tensor parallelism (o/down, out_proj/fc2,
        dense/dense_4h_to_h): the TP engine's shards all-reduce them."""
        return linear(x, w, self.spec.act)

    def _token_quant(self, x, qcfg):
        """A per-token activation quantizer over x's last axis (OPT's q/k/v
        before the head reshape): the TP engine's shards take its ranges
        over every shard's features."""
        return maybe_quant(x, qcfg)

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
        return x + self._out_linear(act, p["down_proj"])

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
        committed = commit(k, v)
        if isinstance(committed, _Int8Window):
            # int8 decode: the fused kernel reads the codes of the window
            # (and the ring), never a dequantized copy
            w = committed
            attn = decode_attention_int8(
                q[:, :, 0], w.k, w.k_scale, w.v, w.v_scale, w.lengths,
                w.kv_len, self._sm_scale(), out_dtype=self.dtype,
                ring_kv=w.ring, ring_n=w.ring_n)
            return self._attn_out(p, attn.reshape(b, s, -1))
        k_all, v_all = committed
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
        slots = torch.full((1,), slot, dtype=torch.int32, device=self.device)
        for li, p in enumerate(self.params["layers"]):
            def commit(k, v, _li=li):
                # prefill attends the fresh k/v, not what the cache stores
                self._commit_prefill(self.cache, _li, slots, k, v)
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
                self._commit_prefill(self.cache, _li, slots, k, v)
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
                # one launch writes every buffer of the layer (codes and
                # scale planes for an int8 cache)
                kv_cache_write(self._layer_bufs(self.cache, _li),
                               self._rows(k[:, :, 0], v[:, :, 0]), lengths)
                if self.attn_kernel:
                    return self._window(_li, kv_len, lengths)
                return self._read_kv(self.cache, _li, kv_len)
            x = self._block(p, x, positions, mask, commit)
        return self._head(self.params, x)[:, 0]

    def _decode_multi_impl(self, last_tokens, lengths, kv_len: int,
                           n_steps: int, do_sample: bool):
        """n_steps decode steps with no host round trip; (B, n_steps).

        With the fused int8 attention (``_use_ring``), step i quantizes its
        k/v into index i of small zeroed per-layer rings of n_steps rows
        instead of the cache; the kernel attends the cache window [0, base)
        and then ring rows 0..i, and at the end one span write per layer
        flushes the rings to positions base..base+n_steps-1."""
        controls = self._controls(slice(None)) if do_sample else (None,) * 3
        if n_steps == 1 or not self._use_ring():
            toks, lens, outs = last_tokens, lengths, []
            for _ in range(n_steps):
                logits = self._decode_impl(toks, lens, kv_len)
                toks = self._select(logits, *controls, do_sample)
                lens = lens + 1
                outs.append(toks)
            return torch.stack(outs, dim=1)

        cfg, base = self.cfg, lengths
        n_layers = len(self.params["layers"])
        ring_shape = (n_layers, self.max_batch, cfg.num_key_value_heads,
                      n_steps)
        rings = [torch.zeros(ring_shape + (cfg.head_dim,), dtype=torch.int8,
                             device=self.device) for _ in range(2)]
        rings += [torch.zeros(ring_shape, dtype=torch.float32,
                              device=self.device) for _ in range(2)]
        toks, outs = last_tokens, []
        for i in range(n_steps):
            positions = (base + i)[:, None]
            x = self._embed(self.params, toks[:, None], positions)
            for li, p in enumerate(self.params["layers"]):
                def commit(k, v, _li=li, _i=i):
                    rkc, rvc, rks, rvs = (r[_li] for r in rings)
                    for ring, row in zip((rkc, rvc, rks, rvs),
                                         self._rows(k[:, :, 0], v[:, :, 0])):
                        ring[:, :, _i] = row
                    # the window [0, base) holds the past; the ring the rest
                    return self._window(_li, kv_len, base - 1,
                                        (rkc, rks, rvc, rvs), _i)
                # the fused kernel masks by itself: no additive mask
                x = self._block(p, x, positions, None, commit)
            logits = self._head(self.params, x)[:, 0]
            toks = self._select(logits, *controls, do_sample)
            outs.append(toks)
        for li in range(n_layers):
            kv_cache_write_span(self._layer_bufs(self.cache, li),
                                tuple(r[li] for r in rings), base)
        return torch.stack(outs, dim=1)

    def _use_ring(self) -> bool:
        """Whether step_n stages its tokens in rings the fused int8 kernel
        attends (int8 engines with attn_kernel only)."""
        return self.attn_kernel

    def _verify_impl(self, tokens, lengths, kv_len: int,
                     return_logits: bool):
        """Score s known tokens per slot in one forward (the speculative-
        decoding verify pass): tokens (B, s) enter at positions
        lengths..lengths+s-1 and their k/v are written there with one span
        write per layer; the mask bounds each query at its own position, so
        entries past what the caller later accepts are never attended.
        Returns the (B, s) argmax tokens, or the (B, s, V) f32 logits."""
        s = tokens.shape[1]
        positions = lengths[:, None] + torch.arange(s, device=self.device)
        x = self._embed(self.params, tokens, positions)
        kv_positions = torch.arange(kv_len, device=self.device)
        neg = torch.finfo(self.dtype).min
        mask = torch.where(kv_positions[None, None, None, :]
                           <= positions[:, None, :, None], 0.0, neg)
        mask = mask.to(self.dtype)  # (B, 1, s, kv_len)
        for li, p in enumerate(self.params["layers"]):
            def commit(k, v, _li=li):
                kv_cache_write_span(self._layer_bufs(self.cache, _li),
                                    self._rows(k, v), lengths)
                return self._read_kv(self.cache, _li, kv_len)
            x = self._block(p, x, positions, mask, commit)
        logits = self._head(self.params, x)
        if return_logits:
            return logits.float()
        return torch.argmax(logits, dim=-1).to(torch.int32)

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
        for every slot); with auto_grow the cache grows instead. The CUDA
        write drops such a row rather than clamping it, but the slot's
        history would still be cut short."""
        check = set(int(s) for s in np.nonzero(self.active)[0])
        check.update(int(s) for s in slots)
        need = max((int(self.lengths[s]) + n for s in check), default=0)
        if need <= self.max_len:
            return
        if not self.auto_grow:
            over = [s for s in sorted(check)
                    if self.lengths[s] + n > self.max_len]
            raise RuntimeError(
                f"slots {over} would exceed max_len={self.max_len} after "
                f"{n} step(s) (lengths {[int(self.lengths[s]) for s in over]});"
                " release them, enable auto_grow, or build the engine with"
                " a larger max_len")
        self._grow(need)

    def _ensure_prefill_capacity(self, bucket: int):
        """A prompt bucket longer than the cache grows it or is refused."""
        if bucket <= self.max_len:
            return
        if not self.auto_grow:
            raise RuntimeError(
                f"prompt bucket {bucket} exceeds max_len={self.max_len}; "
                "enable auto_grow or build the engine with a larger max_len")
        self._grow(bucket)

    def _grow_target(self, need: int) -> int:
        new_len = self.max_len
        while new_len < need:
            new_len *= 2
        if new_len > self.grow_limit:
            raise RuntimeError(
                f"cannot grow cache to {new_len} (> grow_limit="
                f"{self.grow_limit}, cfg.max_position_embeddings)")
        return new_len

    def _grow(self, need: int):
        """Double max_len (to at least ``need``, at most grow_limit) and copy
        the cache into new buffers at [:, :, :old max_len]: each layer's
        codes or rows and an int8 cache's scale planes. The old and the new
        buffers are both held until the copy ends."""
        new_len = self._grow_target(need)
        old, old_len = self.cache, self.max_len
        self.max_len = new_len
        self.cache = self._init_cache()
        for name in ("k", "v", "k_scale", "v_scale"):
            for dst, src in zip(getattr(self.cache, name) or (),
                                getattr(old, name) or ()):
                dst[:, :, :old_len].copy_(src)

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

    def _verify_call(self, tokens: dict, return_logits: bool) -> np.ndarray:
        """Shared body of verify_step/verify_step_logits: the (B, s) token
        buffer, the window bucket, and one verify pass, which writes k/v at
        lengths..lengths+s-1 without advancing ``lengths``."""
        s = len(next(iter(tokens.values())))
        if not all(len(t) == s for t in tokens.values()):
            raise ValueError(
                "verify requires the same number of tokens per slot (got "
                f"lengths {sorted(set(len(t) for t in tokens.values()))})")
        self._check_capacity(tokens, s)
        toks = np.zeros((self.max_batch, s), np.int32)
        for sl, ts in tokens.items():
            toks[sl] = ts
        dev = self.device
        out = self._verify_impl(
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(self.lengths, device=dev), self._kv_len(s + 1),
            return_logits)
        return out.cpu().numpy()

    def verify_step(self, tokens: dict) -> dict:
        """Speculative-decoding verify: tokens {slot: [s tokens]} (the same
        s for every slot) are scored in one pass and their k/v written at
        positions lengths..lengths+s-1; ``lengths`` is NOT advanced (the
        caller advances it by the tokens it accepts; the rest are never
        attended and are overwritten later). Returns {slot: [s argmax
        tokens]}, entry i the model's next token after tokens[:i+1]."""
        out = self._verify_call(tokens, return_logits=False)
        return {sl: out[sl].tolist() for sl in tokens}

    def verify_step_logits(self, tokens: dict) -> dict:
        """verify_step returning the f32 logit rows instead of argmaxes:
        {slot: (s, V) float32 ndarray}, with the same cache writes."""
        out = self._verify_call(tokens, return_logits=True)
        return {sl: out[sl] for sl in tokens}

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


class OPTEngine(LlamaEngine):
    """Continuous-batching decoder for the OPT family (pre-LN models; the
    post-LN variant, OPT-350m, is served by the eval path only).

    Counterpart of ``omniquant_tpu/serving/engine.py::OPTEngine``: the
    family hooks add the learned positions (offset by 2, indexed on the
    device) at embed time, use LayerNorm with bias, no RoPE, a ReLU
    fc1/fc2 MLP and the final LayerNorm in the head; q is scaled by
    head_dim**-0.5 and then quantized, and q/k/v are quantized per token
    over the full hidden dim before the head reshape, so the shared
    attention paths apply scale 1.0 and no further quantizer."""

    def __init__(self, params: dict, cfg: topt.OPTConfig, **kw):
        if not cfg.do_layer_norm_before:
            raise ValueError("OPTEngine serves pre-LN OPT models "
                             "(do_layer_norm_before=True)")
        self._ocfg = cfg
        # the llama-named attributes the base engine reads
        view = SimpleNamespace(
            **dataclasses.asdict(cfg),
            num_key_value_heads=cfg.num_attention_heads,
            head_dim=cfg.head_dim, n_rep=1, intermediate_size=cfg.ffn_dim,
            rms_norm_eps=cfg.layer_norm_eps, rope_theta=0.0)
        super().__init__(params, view, **kw)

    def _embed(self, params, tokens, positions):
        return topt.embed(params, tokens, self._ocfg, positions)

    def _head(self, params, x):
        return topt.head(params, x, self._ocfg)

    def _attn_norm(self, p, x):
        return layer_norm(x, p["self_attn_layer_norm"],
                          self._ocfg.layer_norm_eps)

    def _attn_qkv(self, p, hidden, positions):
        b, s, _ = hidden.shape
        hd = self.cfg.head_dim
        h = self.cfg.num_attention_heads * hd  # the heads this engine owns
        if "qkv_fused" in p:
            qkv = linear(hidden, p["qkv_fused"], self.spec.act)
            q, k, v = qkv[..., :h], qkv[..., h: 2 * h], qkv[..., 2 * h:]
        else:
            q = linear(hidden, p["q_proj"], self.spec.act)
            k = linear(hidden, p["k_proj"], self.spec.act)
            v = linear(hidden, p["v_proj"], self.spec.act)
        q = self._token_quant(q * (hd ** -0.5), self.spec.q)
        k = self._token_quant(k, self.spec.k)
        v = self._token_quant(v, self.spec.v)

        def heads(y):
            return y.reshape(b, s, self.cfg.num_attention_heads,
                             hd).transpose(1, 2)

        return heads(q), heads(k), heads(v)

    def _quant_qkv(self, q, k, v):
        return q, k, v  # quantized before the head reshape in _attn_qkv

    def _sm_scale(self) -> float:
        return 1.0  # q is scaled in _attn_qkv

    def _attn_out(self, p, attn):
        return self._out_linear(attn, p["out_proj"])

    def _mlp(self, p, x):
        h = layer_norm(x, p["final_layer_norm"], self._ocfg.layer_norm_eps)
        h = torch.relu(linear(h, p["fc1"], self.spec.act))
        return x + self._out_linear(h, p["fc2"])


class FalconEngine(LlamaEngine):
    """Continuous-batching decoder for the Falcon family: multi-query,
    classic multi-head and the new decoder architecture's grouped kv
    heads; rotary or ALiBi positions; parallel attention, dual LayerNorms
    or a post-attention LayerNorm.

    Counterpart of ``omniquant_tpu/serving/engine.py::FalconEngine``. The
    cache holds the model's true kv heads (one under multi-query) and the
    attention paths repeat them on read. ALiBi is folded into the additive
    mask in f32 (and handed to the flash prefill as slopes); the fused int8
    decode attention never sees that mask, so an ALiBi engine keeps
    ``attn_kernel`` off and its int8 decode takes the dequantized dense
    path. The attention matmuls take no activation quantizer (only the
    linears' inputs do)."""

    def __init__(self, params: dict, cfg: tfalcon.FalconConfig, **kw):
        self._fcfg = cfg
        n_kv = cfg.effective_kv_heads
        # the llama-named attributes the base engine reads
        view = SimpleNamespace(
            **dataclasses.asdict(cfg), num_key_value_heads=n_kv,
            head_dim=cfg.head_dim, n_rep=cfg.num_attention_heads // n_kv,
            rms_norm_eps=cfg.layer_norm_eps)
        super().__init__(params, view, **kw)
        self._slopes = self._bias = None
        if cfg.alibi:
            self.attn_kernel = False
            # made once (and again when the cache grows): the slopes come
            # from a host list, and the copy of one to the card makes the
            # host wait for it
            self._slopes = self._make_slopes()
            self._bias = tfalcon.alibi_bias(cfg, self.max_len, self.device,
                                            self._slopes)

    def _grow(self, need: int):
        super()._grow(need)
        if self._bias is not None:  # the ALiBi bias spans max_len
            self._bias = tfalcon.alibi_bias(self._fcfg, self.max_len,
                                            self.device, self._slopes)

    def _alibi_slopes(self):
        return self._slopes

    def _make_slopes(self):
        """The ALiBi slopes of this engine's heads, on its device."""
        return tfalcon.alibi_slopes(self._fcfg.num_attention_heads,
                                    self.device)

    def _quant_qkv(self, q, k, v):
        return q, k, v  # the attention matmuls are not quantized

    def _embed(self, params, tokens, positions):
        return tfalcon.embed(params, tokens).to(self.dtype)

    def _head(self, params, x):
        return tfalcon.head(params, x, self._fcfg)

    def _attn_qkv(self, p, hidden, positions):
        cfg = self._fcfg
        fused = linear(hidden, p["query_key_value"], self.spec.act)
        q, k, v = (t.transpose(1, 2)
                   for t in tfalcon.split_heads_kv(fused, cfg))
        if not cfg.alibi:
            cos, sin = tllama.rope_cos_sin(
                positions, cfg.head_dim, cfg.rope_theta, dtype=hidden.dtype)
            q, k = tllama.apply_rope(q, k, cos, sin)
        return q, k, v

    def _attn_out(self, p, attn):
        return self._out_linear(attn, p["dense"])

    def _block(self, p, x, positions, mask, commit):
        cfg = self._fcfg
        if cfg.alibi:
            # an f32 mask: the dense attention adds it to the scores and
            # takes the softmax in f32 (alibi_bias)
            mask = mask + self._bias[..., :mask.shape[-1]]
        residual = x
        if cfg.new_decoder_architecture:
            attn_ln = layer_norm(x, p["ln_attn"], cfg.layer_norm_eps)
            mlp_ln = layer_norm(x, p["ln_mlp"], cfg.layer_norm_eps)
        else:
            attn_ln = layer_norm(x, p["input_layernorm"], cfg.layer_norm_eps)
            mlp_ln = None
        attn_out = self._attn_core(p, attn_ln, positions, mask, commit)
        if not cfg.new_decoder_architecture:
            if cfg.parallel_attn:
                mlp_ln = attn_ln
            else:
                residual = residual + attn_out
                mlp_ln = layer_norm(residual, p["post_attention_layernorm"],
                                    cfg.layer_norm_eps)
        h = torch.nn.functional.gelu(
            linear(mlp_ln, p["dense_h_to_4h"], self.spec.act))
        mlp_out = self._out_linear(h, p["dense_4h_to_h"])
        if cfg.new_decoder_architecture or cfg.parallel_attn:
            mlp_out = mlp_out + attn_out
        return residual + mlp_out
