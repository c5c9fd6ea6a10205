"""Tensor-parallel serving engine: the continuous-batching engine sharded
over the shards of a ``parallel.mesh.Mesh``.

Counterpart of ``omniquant_tpu/serving/tp_engine.py``. The JAX engine runs
its jitted step programs inside ``shard_map``; here a TP engine holds one
shard engine per shard -- the family's single engine built on a local
(per-shard) configuration, with its own weights, KV cache and generator on
its shard's device -- and runs each step program on all of them at once
(``Mesh.run``, one thread a shard). The shard engines meet at the mesh's
collectives; the host-side continuous batching (slots, buckets, sampling
controls, capacity checks, growth) is the single engine's, run once by the
TP engine, whose slot arrays the shards share.

  * weights: row-parallel (q/k/v/gate/up/fc1/query_key_value) split their
    output lanes; column-parallel (o/down/out_proj/fc2/dense/
    dense_4h_to_h) split their packed rows and all-reduce their partial
    products (one all-reduce per block per site). Placement reuses
    parallel/tp_forward.py's padding and splitting (padded MLP
    intermediates with exactly zero contributions, Falcon multi-query
    lanes restructured).
  * KV cache: head-sharded, each shard owns (B, n_kv/tp, max_len, hd) of
    every layer (and its slice of the int8 scale planes). The kv_update
    kernels and the int8 decode attention run per shard on its heads; the
    cache is never communicated.
  * the qkv and gate+up fusion interleaves lanes per shard ([q_0 k_0 v_0 |
    q_1 k_1 v_1 | ...]), so a plain row split gives every shard its own
    [q_l, k_l, v_l] and the engine's split by local size holds.
  * activation quantization stays exact: row-parallel inputs are whole on
    every shard (their per-token ranges are the global ones);
    column-parallel inputs are split over features, so their per-token min
    and max come from an all-reduce before the fake-quant, bit-identical to
    the single engine's ranges. OPT's q/k/v, quantized per token over the
    whole hidden, do the same. A grouped activation quantizer is refused
    (its groups would straddle shards). The quantizer is the TP trunk's
    (``parallel/tp_forward.py::tp_act_quant``).
  * the all-reduce hands every shard the same bits, so the replicated
    hidden states and logits, and every shard's sampling (each shard draws
    from its own generator, seeded alike), never diverge.

On a mesh that spans processes (``parallel/multihost.py``) a rank places
and builds only its own shards (``local_shards``; the other ranks' entries
of ``shards`` are None): it never holds their weights or cache. Every rank
receives the same calls, so the host-side batching, replicated, stays in
step, and each step program returns the first local shard's result,
which the all-reduce made the same bits on every rank.

JAX's ``lower_step`` (AOT-lowering a step at full geometry without running
it) has no counterpart: it only rehearsed XLA compiles.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch

from .. import resolve_device
from ..parallel.tp_forward import (
    COL_PARALLEL, ROW_PARALLEL, _MLP_NAMES, _col_linear_q,
    _ensure_col_splittable, local_falcon_config, pad_intermediate_packed,
    place_block, replicate, restructure_falcon_mqa, tp_act_quant)
from ..quant.packing import PackedWeight
from .engine import FalconEngine, LlamaEngine, OPTEngine


# ---------------------------------------------------------------------------
# TP-aware fusion: per-shard interleaved lanes
# ---------------------------------------------------------------------------

def fuse_packed_tp(pws, tp: int) -> Optional[PackedWeight]:
    """Fuse packed linears that share in_features with lanes interleaved
    per shard: shard i's contiguous chunk is [pw0_i, pw1_i, ...], so a
    plain row split of the result gives each shard its own fused
    [q_l, k_l, v_l]. None where the fusion does not apply (as
    ``engine.fuse_packed``, and where a part does not split into tp)."""
    if not all(isinstance(p, PackedWeight) for p in pws):
        return None
    first = pws[0]
    if not all(
        p.bits == first.bits and p.group_size == first.group_size
        and p.in_features == first.in_features and p.tile_k == first.tile_k
        and p.layout == first.layout
        and p.qweight.shape[0] == first.qweight.shape[0]
        and p.out_features % tp == 0
        for p in pws
    ):
        return None
    qs, ss, zs, bs = [], [], [], []
    any_bias = any(p.bias is not None for p in pws)
    for i in range(tp):
        for p in pws:
            o_l = p.out_features // tp
            sl = slice(i * o_l, (i + 1) * o_l)
            qs.append(p.qweight[:, sl])
            ss.append(p.scales[sl])
            zs.append(p.zeros[sl])
            if any_bias:
                b = (p.bias if p.bias is not None else torch.zeros(
                    p.out_features, dtype=torch.float32,
                    device=p.qweight.device))
                bs.append(b[sl])
    return PackedWeight(
        qweight=torch.cat(qs, dim=1), scales=torch.cat(ss, dim=0),
        zeros=torch.cat(zs, dim=0),
        bias=torch.cat(bs) if any_bias else None,
        bits=first.bits, group_size=first.group_size,
        in_features=first.in_features,
        out_features=sum(p.out_features for p in pws),
        tile_k=first.tile_k, layout=first.layout)


_FUSE_SITES = {
    "llama": (("q_proj", "k_proj", "v_proj", "qkv_fused"),
              ("gate_proj", "up_proj", "gate_up_fused")),
    "opt": (("q_proj", "k_proj", "v_proj", "qkv_fused"),),
    "falcon": (),
}


def _cast(x, dtype):
    """``x`` with every floating tensor (PackedWeight scales, zeros and
    bias included) in ``dtype``, on its own device."""
    if isinstance(x, PackedWeight):
        return x.map_tensors(lambda t: _cast(t, dtype))
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cast(v, dtype) for v in x]
    return x


def place_params(params: dict, gcfg, mesh, family: str, dtype):
    """Pad, restructure, fuse and place a whole engine param tree for TP:
    one tree per local shard on its device (None at other ranks' shards,
    whose weights this rank never holds), floating tensors in ``dtype``.
    Returns (per-shard trees, the padded intermediate size). The fused
    projections replace their parts. The split is over a row's tp shards;
    the dp rows of a (dp, tp) mesh hold the same parts."""
    tp = mesh.tp
    rows, cols = set(ROW_PARALLEL[family]), set(COL_PARALLEL[family])
    for site in _FUSE_SITES[family]:
        rows.add(site[-1])  # fused names are row-parallel
    rest = _cast({k: v for k, v in params.items() if k != "layers"}, dtype)
    placed = [None if tree is None else dict(tree, layers=[])
              for tree in replicate(rest, mesh)]
    inter_pad = None
    for block in params["layers"]:
        block = _cast(dict(block), dtype)
        block = pad_intermediate_packed(block, gcfg, tp, family)
        if (family == "falcon" and gcfg.multi_query
                and not gcfg.new_decoder_architecture and tp > 1):
            block = restructure_falcon_mqa(block, gcfg, tp)
        if inter_pad is None:
            w0 = block[_MLP_NAMES[family][0][0]]
            inter_pad = (w0.out_features if isinstance(w0, PackedWeight)
                         else w0["weight"].shape[0])
        for site in _FUSE_SITES[family]:
            fused = fuse_packed_tp([block.get(n) for n in site[:-1]], tp)
            if fused is not None:
                block[site[-1]] = fused
                for n in site[:-1]:
                    del block[n]
        block = {name: (_ensure_col_splittable(w, tp)
                        if name in cols and isinstance(w, PackedWeight)
                        else w) for name, w in block.items()}
        for tree, shard in zip(placed, place_block(block, mesh, rows, cols)):
            if tree is not None:
                tree["layers"].append(shard)
    return placed, inter_pad


# ---------------------------------------------------------------------------
# the shard engines
# ---------------------------------------------------------------------------

class _ShardMixin:
    """One shard's engine: the family engine on a local configuration,
    whose split linears and per-token quantizers meet the other shards at
    the mesh's collectives."""

    def _shard_setup(self, gcfg, mesh, p: int, overlap_chunks: int):
        # p meets the collectives; the column picks the shard's part
        self._gcfg, self._mesh, self._p = gcfg, mesh, p
        self._col = p % mesh.tp
        self.overlap_chunks = overlap_chunks

    def _prep_params(self, params):
        return params  # placed, in the engine dtype, by place_params

    def _token_quant(self, x, qcfg):
        """Per-token fake-quant whose min/max span the whole feature row
        (``parallel.tp_forward.tp_act_quant``)."""
        return tp_act_quant(self._mesh, self._p, x, qcfg)

    def _out_linear(self, x, w):
        """Column-parallel: the exact input quantizer, then the local
        product, the all-reduce and the bias once."""
        return _col_linear_q(x, w, self._mesh, self._p, self.overlap_chunks,
                             self.spec.act)


def _view(cfg, **overrides) -> SimpleNamespace:
    return SimpleNamespace(**{**dataclasses.asdict(cfg), **overrides})


class _LlamaShard(_ShardMixin, LlamaEngine):
    def __init__(self, params, cfg, mesh, p, overlap_chunks, inter_pad, **kw):
        self._shard_setup(cfg, mesh, p, overlap_chunks)
        tp = mesh.tp
        local = _view(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                      num_key_value_heads=cfg.num_key_value_heads // tp,
                      head_dim=cfg.head_dim, n_rep=cfg.n_rep,
                      intermediate_size=inter_pad // tp)
        LlamaEngine.__init__(self, params, local, device=mesh.devices[p],
                             **kw)


class _OPTShard(_ShardMixin, OPTEngine):
    def __init__(self, params, cfg, mesh, p, overlap_chunks, inter_pad, **kw):
        self._shard_setup(cfg, mesh, p, overlap_chunks)
        self._ocfg = cfg
        nh_l = cfg.num_attention_heads // mesh.tp
        local = _view(cfg, num_attention_heads=nh_l, num_key_value_heads=nh_l,
                      head_dim=cfg.head_dim, n_rep=1,
                      intermediate_size=cfg.ffn_dim,
                      rms_norm_eps=cfg.layer_norm_eps, rope_theta=0.0)
        # OPTEngine.__init__ would build the global view
        LlamaEngine.__init__(self, params, local, device=mesh.devices[p],
                             **kw)


class _FalconShard(_ShardMixin, FalconEngine):
    def __init__(self, params, cfg, mesh, p, overlap_chunks, inter_pad, **kw):
        self._shard_setup(cfg, mesh, p, overlap_chunks)
        FalconEngine.__init__(self, params, local_falcon_config(cfg, mesh.tp),
                              device=mesh.devices[p], **kw)

    def _make_slopes(self):
        """This shard's slice of the global ALiBi slopes: they depend on
        the global head count and index, and the row split gives the shard
        in column c heads [c * nh_l, (c + 1) * nh_l)."""
        from ..models.falcon import alibi_slopes

        nh_l = self._fcfg.num_attention_heads
        full = alibi_slopes(self._gcfg.num_attention_heads, self.device)
        return full[self._col * nh_l:(self._col + 1) * nh_l].contiguous()


# ---------------------------------------------------------------------------
# the TP engines
# ---------------------------------------------------------------------------

_SLOT_STATE = ("lengths", "active", "temps", "top_ks", "top_ps")


class _TPMixin:
    """The host side of a TP engine over a family engine class: its
    continuous batching runs once, and every step program runs on the shard
    engines (``shards``), one thread each, which return the same
    (replicated) result; shard 0's is the engine's."""

    _family = None
    _shard_cls = None

    def __init__(self, params: dict, cfg, mesh, overlap_chunks: int = 1,
                 **kw):
        if "device" in kw:
            raise TypeError("a TP engine runs on its mesh's devices; it "
                            "takes no device")
        for p in mesh.local:  # a card that is not there raises here
            resolve_device(mesh.devices[p])
        self.mesh, self.tp = mesh, mesh.tp
        self._gcfg = cfg
        self.overlap_chunks = overlap_chunks
        self._raw_params = params  # spec-decode drafts re-place from raw
        self._check_heads(cfg)
        placed, inter_pad = place_params(params, cfg, mesh, self._family,
                                         kw.get("dtype", torch.bfloat16))
        self.shards = mesh.each(lambda p, d: self._shard_cls(
            placed[p], cfg, mesh, p, overlap_chunks, inter_pad, **kw))
        del placed
        super().__init__(None, cfg, device=mesh.devices[mesh.local[0]], **kw)
        for s in self.local_shards:  # one host state, read by every shard
            for name in _SLOT_STATE:
                setattr(s, name, getattr(self, name))

    def _check_heads(self, cfg):
        if cfg.num_attention_heads % self.tp:
            raise ValueError(f"{cfg.num_attention_heads} heads do not "
                             f"divide into tp={self.tp} shards")

    @property
    def local_shards(self) -> list:
        """This rank's shard engines (every shard on an in-process mesh)."""
        return [self.shards[p] for p in self.mesh.local]

    def _prep_params(self, params):
        return [None if s is None else s.params for s in self.shards]

    def _init_cache(self):
        return [None if s is None else s.cache for s in self.shards]

    def _grow(self, need: int):
        new_len = self._grow_target(need)
        self.mesh.run(lambda p: self.shards[p]._grow(need))
        self.max_len = new_len
        self.cache = self._init_cache()

    def _on_shards(self, name: str, *args, **kw):
        """shard.<name>(*args, **kw) on every local shard at once, each with
        its own copy of the tensor args on its device; the first local
        shard's result (the same bits on every shard and rank)."""
        per = [self.mesh.each(lambda p, d, a=a: a.to(d) if isinstance(
            a, torch.Tensor) else a) for a in args]
        return self.mesh.first(self.mesh.run(
            lambda p, *a: getattr(self.shards[p], name)(*a, **kw), *per))

    def _prefill_impl(self, tokens, slot: int, last_idx: int, seq_len: int):
        return self._on_shards("_prefill_impl", tokens, slot, last_idx,
                               seq_len=seq_len)

    def _prefill_multi_impl(self, tokens, slots, last_idx, seq_len: int):
        return self._on_shards("_prefill_multi_impl", tokens, slots,
                               last_idx, seq_len=seq_len)

    def _decode_impl(self, last_tokens, lengths, kv_len: int):
        return self._on_shards("_decode_impl", last_tokens, lengths, kv_len)

    def _decode_multi_impl(self, last_tokens, lengths, kv_len: int,
                           n_steps: int, do_sample: bool):
        return self._on_shards("_decode_multi_impl", last_tokens, lengths,
                               kv_len, n_steps, do_sample)

    def _verify_impl(self, tokens, lengths, kv_len: int,
                     return_logits: bool):
        return self._on_shards("_verify_impl", tokens, lengths, kv_len,
                               return_logits)

    def _select(self, logits, temps, top_ks, top_ps, do_sample: bool):
        """Every shard draws from its own generator, so they stay in
        step for the samples drawn inside later step programs."""
        return self._on_shards("_select", logits, temps, top_ks, top_ps,
                               do_sample)


class TPLlamaEngine(_TPMixin, LlamaEngine):
    """Tensor-sharded llama-family continuous-batching engine."""

    _family = "llama"
    _shard_cls = _LlamaShard

    def _check_heads(self, cfg):
        super()._check_heads(cfg)
        if cfg.num_key_value_heads % self.tp:
            raise ValueError(f"{cfg.num_key_value_heads} kv heads do not "
                             f"divide into tp={self.tp} shards")


class TPOPTEngine(_TPMixin, OPTEngine):
    """Tensor-sharded OPT-family engine (pre-LN models)."""

    _family = "opt"
    _shard_cls = _OPTShard

    def _check_heads(self, cfg):
        if not cfg.do_layer_norm_before:
            raise ValueError("OPTEngine serves pre-LN OPT models "
                             "(do_layer_norm_before=True)")
        super()._check_heads(cfg)


class TPFalconEngine(_TPMixin, FalconEngine):
    """Tensor-sharded Falcon-family engine.

    Multi-query (falcon-7b): restructure_falcon_mqa rewrites the fused qkv
    so every shard computes its own replica of the shared k/v head; each
    shard caches that one head (tp replicas of one head's cache: small next
    to the weights). The new decoder architecture splits its kv groups.
    ALiBi: each shard holds its heads' slice of the slopes computed for the
    global head count, in f32 as the single engine keeps them, for the
    flash prefill and the folded mask alike."""

    _family = "falcon"
    _shard_cls = _FalconShard

    def _check_heads(self, cfg):
        super()._check_heads(cfg)
        local_falcon_config(cfg, self.tp)  # raises on kv heads


TP_ENGINES = {
    "llama": TPLlamaEngine,
    "opt": TPOPTEngine,
    "falcon": TPFalconEngine,
}
