"""Ring attention: causal attention over a sequence split into n blocks.

Counterpart of ``omniquant_tpu/parallel/ring_attention.py``. Shard p of an
n-shard sequence-parallel (SP) mesh holds the p-th block of q, k and v on
its device; k/v blocks rotate around the ring (shard p hands its current
block to shard p + 1), and each shard merges the partial attention of its
q block over every k/v block it meets with the online-softmax recurrence,
so the result equals attention over the whole sequence while no shard ever
holds more than S/n of it.

JAX drives the n devices of a mesh from one process through ``shard_map``
and rotates with ``ppermute``. Here each shard runs its own loop over the
ring's n steps (``ring_attention_shard``): it attends its q block to the
k/v block it holds, then shifts k/v to shard p + 1 (``Mesh.shift``, JAX's
``ppermute``). On a mesh in one process (``SPMesh.run``: one thread a
shard) the shift is a device copy, nothing on one card; on a mesh that
spans the ranks of a process group it is a point-to-point exchange, whose
backward shifts the gradients the other way (the transpose of
``ppermute``), so the plain ring is differentiable across processes. A rank
holds one k/v block a shard at a time, never the whole sequence.
``ring_attention_local`` runs the n shards' loops for lists of blocks in
one process.

Two per-block implementations:
  impl="flash" (the default on a CUDA tensor): K2 with its softmax stats
    (``kernels/flash_attention.py``, ``return_stats``) computes each
    (q block x k/v block) partial, causal on the diagonal (step 0) and
    unmasked off it; the ring merges the normalised partials. On the card
    K2 takes bf16, so q/k/v are cast to bf16 once, the bf16 k/v blocks
    rotate, and each partial is cast back to f32 before the merge.
  impl="plain" (the default on a CPU tensor; JAX's "jnp"): f32 blocks,
    differentiable through autograd (K2 has no backward). Sequence-parallel
    calibration's train step takes it.
With the causal ring schedule, step i > 0 hands shard p the block of
shard p - i (mod n): every key visible where p >= i, every key masked
where p < i. JAX computes a masked block and gates its stats to (m, l) =
(-1e30, 0), whose merge is the identity (a1 = 1, a2 = 0); both
implementations here skip it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import Mesh

_NEG = -1e30


def _block_update(q, k, v, q_pos, k_pos, sm_scale, m, l, acc, causal):
    """One (q block x k/v block) partial-attention update in f32 (JAX's
    ``_block_update``). q (B, H, Sq, D), k/v (B, H, Sk, D); q_pos (Sq,) and
    k_pos (Sk,) global positions, or None where no mask applies; m/l
    (B, H, Sq, 1), acc (B, H, Sq, D) f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal and q_pos is not None:
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                        torch.full_like(s, _NEG))
    m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_next)
    p = torch.exp(s - m_next)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p, v.float())
    return m_next, l, acc


def _merge(m, l, acc, o_b, m_b, l_b):
    """Online-softmax merge of a normalised partial (o_b, m_b, l_b) into the
    running (m, l, acc) (JAX's ``_merge``). Stats (..., Sq, 1), o_b
    (..., Sq, D)."""
    m_next = torch.maximum(m, m_b)
    a1 = torch.exp(m - m_next)
    a2 = torch.exp(m_b - m_next) * l_b
    return m_next, l * a1 + a2, acc * a1 + o_b.float() * a2


def _default_impl(t: torch.Tensor) -> str:
    return "flash" if t.is_cuda else "plain"


def ring_attention_shard(p: int, n: int, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, shift,
                         sm_scale: Optional[float] = None,
                         causal: bool = True, impl: Optional[str] = None):
    """Shard p's part of ring attention over n shards: q (B, H, S/n, D) and
    k/v (B, Hkv, S/n, D) its blocks, H % Hkv == 0; ``shift(kv)`` hands the
    stacked (2, B, Hkv, S/n, D) k/v this shard holds to shard p + 1 and
    returns shard p - 1's. Step i attends q to the block of shard p - i and
    merges it (skipped where causality masks it whole: p < i); the merge
    order is the steps'. Returns the (B, H, S/n, D) output in q's dtype."""
    B, H, s_local, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group onto {Hkv} kv heads")
    if not k.shape[2] == v.shape[2] == s_local:
        raise ValueError("every block of the ring must hold S/n rows")
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if impl == "flash":
        from ..kernels.flash_attention import flash_attention

        # K2 takes bf16 on the card; on the CPU its plain version takes any
        kd = torch.bfloat16 if q.is_cuda else q.dtype
        q_in = q.to(kd)
        kv = torch.stack([k.to(kd), v.to(kd)])
    else:
        n_rep = H // Hkv
        kv = torch.stack([k, v])
    dev = q.device
    m = torch.full((B, H, s_local, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, s_local, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, s_local, D), dtype=torch.float32, device=dev)
    for i in range(n):
        if not (causal and p < i):  # else the block of shard p - i + n
            diag = i == 0
            k_cur, v_cur = kv.unbind(0)
            if impl == "flash":
                o_b, m_b, l_b = flash_attention(
                    q_in, k_cur, v_cur, sm_scale=sm_scale,
                    causal=causal and diag, return_stats=True)
                m, l, acc = _merge(m, l, acc, o_b, m_b[..., None],
                                   l_b[..., None])
            else:
                if n_rep > 1:
                    k_cur = k_cur.repeat_interleave(n_rep, dim=1)
                    v_cur = v_cur.repeat_interleave(n_rep, dim=1)
                pos = torch.arange(s_local, device=dev) if diag else None
                m, l, acc = _block_update(q, k_cur, v_cur, pos, pos,
                                          sm_scale, m, l, acc, causal)
        if i != n - 1:
            kv = shift(kv)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _check_impl(q: torch.Tensor, impl: Optional[str]) -> str:
    impl = impl or _default_impl(q)
    if impl not in ("flash", "plain"):
        raise ValueError(f"impl must be 'flash' or 'plain', not {impl!r}")
    return impl


def ring_attention_local(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         sm_scale: Optional[float] = None,
                         causal: bool = True,
                         impl: Optional[str] = None) -> list:
    """Ring attention over n shards' blocks in this process: qs[p] (B, H,
    S/n, D) and ks[p]/vs[p] (B, Hkv, S/n, D) on shard p's device. Runs
    every shard's ``ring_attention_shard`` on a mesh of the blocks'
    devices and returns the n outputs (B, H, S/n, D) in q's dtype, each on
    its shard's device.

    Each call adds one to ``ring_attention_local.calls[impl]``."""
    n = len(qs)
    if not n == len(ks) == len(vs):
        raise ValueError(f"{len(qs)} q, {len(ks)} k and {len(vs)} v blocks")
    impl = _check_impl(qs[0], impl)
    ring_attention_local.calls[impl] += 1
    mesh = Mesh([q.device for q in qs])
    return mesh.run(lambda p, q, k, v: ring_attention_shard(
        p, n, q, k, v, lambda kv: mesh.shift(p, kv), sm_scale, causal, impl),
        qs, ks, vs)


ring_attention_local.calls = {"flash": 0, "plain": 0}


def ring_attention(q, k, v, devices: Sequence,
                   sm_scale: Optional[float] = None, causal: bool = True,
                   impl: Optional[str] = None):
    """Attention with q (B, H, S, D) and k/v (B, Hkv, S, D) split on the
    sequence into len(devices) blocks, block p on devices[p]; returns the
    (B, H, S, D) result on q's device. ``impl`` defaults by the first
    shard's device: "flash" on a card, "plain" on the CPU."""
    n = len(devices)
    S = q.shape[2]
    if S % n:
        raise ValueError(f"a sequence of {S} does not split into {n} blocks")
    devs = [torch.device(d) for d in devices]

    def split(t):
        return [b.to(d) for b, d in zip(t.chunk(n, dim=2), devs)]

    outs = ring_attention_local(split(q), split(k), split(v), sm_scale,
                                causal, impl)
    return torch.cat([o.to(q.device) for o in outs], dim=2)


class SPMesh(Mesh):
    """A sequence-parallel mesh: n shards, shard p on ``devices[p]`` (the
    devices may repeat), held by rank ``ranks[p]`` of the process group
    (None: all in this process). ``run`` (``Mesh.run``) runs one program
    per local shard, each in its own thread (JAX's ``shard_map``); the
    programs meet in ``ring_attention``, which every shard calls with its
    blocks."""

    def ring_attention(self, p: int, q, k, v,
                       sm_scale: Optional[float] = None, causal: bool = True,
                       impl: Optional[str] = None):
        """Shard p's (B, H, S/n, D) q and (B, Hkv, S/n, D) k/v blocks in,
        its output block out (``ring_attention_shard``, its k/v shifted
        round the mesh). Every shard must call it. Each ring adds one to
        ``ring_attention_local.calls[impl]`` on every rank."""
        impl = _check_impl(q, impl)
        if p == self.local[0]:
            ring_attention_local.calls[impl] += 1
        held = []

        def shift(kv):
            held[:] = [self.shift(p, kv)]
            return held[0]

        out = ring_attention_shard(p, self.n, q, k, v, shift, sm_scale,
                                   causal, impl)
        if self.spans_processes and held and held[0].requires_grad:
            # every rank's backward must run every shift (each exchanges
            # with a neighbour), though a shard that causality keeps from
            # the late blocks does not use them: tie the last to the output
            out = _Tie.apply(out, held[0])
        return out


class _Tie(torch.autograd.Function):
    """``out`` unchanged; in the backward, a zero gradient for ``dep``, so
    that autograd runs the nodes ``dep`` comes from."""

    @staticmethod
    def forward(ctx, out, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.dep
        return grad, torch.zeros(shape, dtype=dtype, device=device)
