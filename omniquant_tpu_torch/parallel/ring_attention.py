"""Ring attention: causal attention over a sequence split into n blocks.

Counterpart of ``omniquant_tpu/parallel/ring_attention.py``. Shard p of an
n-shard sequence-parallel (SP) mesh holds the p-th block of q, k and v on
its device; k/v blocks rotate around the ring (shard p hands its current
block to shard p + 1), and each shard merges the partial attention of its
q block over every k/v block it meets with the online-softmax recurrence,
so the result equals attention over the whole sequence while no shard ever
holds more than S/n of it.

JAX drives the n devices of a mesh from one process through ``shard_map``
and rotates with ``ppermute``. Here a mesh is a sequence of n
``torch.device``s (which may repeat: n shards on one card), and one
process runs step i of every shard in lockstep, rotating with
``.to(device of shard p + 1, non_blocking=True)``, a peer copy between
cards and nothing on one card. ``SPMesh.run`` runs one program per shard,
each in its own thread, and ``SPMesh.ring_attention`` is the collective
those programs call (``parallel/mesh.py`` holds the thread machinery).

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

from .mesh import Mesh, _on

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


def ring_attention_local(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         sm_scale: Optional[float] = None,
                         causal: bool = True,
                         impl: Optional[str] = None) -> list:
    """Ring attention over n shards' blocks: qs[p] (B, H, S/n, D) and
    ks[p]/vs[p] (B, Hkv, S/n, D) on shard p's device, H % Hkv == 0. Runs
    the ring's n steps for every shard in lockstep and returns the n
    outputs (B, H, S/n, D) in q's dtype, each on its shard's device.

    Each call adds one to ``ring_attention_local.calls[impl]``."""
    n = len(qs)
    if not n == len(ks) == len(vs):
        raise ValueError(f"{len(qs)} q, {len(ks)} k and {len(vs)} v blocks")
    B, H, s_local, D = qs[0].shape
    Hkv = ks[0].shape[1]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group onto {Hkv} kv heads")
    if any(t.shape[2] != s_local for t in (*qs, *ks, *vs)):
        raise ValueError("every block of the ring must hold S/n rows")
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    impl = impl or _default_impl(qs[0])
    if impl not in ("flash", "plain"):
        raise ValueError(f"impl must be 'flash' or 'plain', not {impl!r}")
    ring_attention_local.calls[impl] += 1
    devices = [q.device for q in qs]
    if impl == "flash":
        from ..kernels.flash_attention import flash_attention

        # K2 takes bf16 on the card; on the CPU its plain version takes any
        kd = torch.bfloat16 if qs[0].is_cuda else qs[0].dtype
        q_in = [q.to(kd) for q in qs]
        k_cur = [k.to(kd) for k in ks]
        v_cur = [v.to(kd) for v in vs]
    else:
        n_rep = H // Hkv
        k_cur = [k.repeat_interleave(n_rep, dim=1) if n_rep > 1 else k
                 for k in ks]
        v_cur = [v.repeat_interleave(n_rep, dim=1) if n_rep > 1 else v
                 for v in vs]
    m = [torch.full((B, H, s_local, 1), _NEG, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((B, H, s_local, 1), dtype=torch.float32, device=d)
         for d in devices]
    acc = [torch.zeros((B, H, s_local, D), dtype=torch.float32, device=d)
           for d in devices]
    for i in range(n):
        for p in range(n):
            if causal and p < i:
                continue  # the block of shard p - i + n: every key masked
            diag = i == 0
            if impl == "flash":
                with _on(devices[p]):
                    o_b, m_b, l_b = flash_attention(
                        q_in[p], k_cur[p], v_cur[p], sm_scale=sm_scale,
                        causal=causal and diag, return_stats=True)
                m[p], l[p], acc[p] = _merge(m[p], l[p], acc[p], o_b,
                                            m_b[..., None], l_b[..., None])
            else:
                pos = None
                if diag:
                    pos = torch.arange(s_local, device=devices[p])
                m[p], l[p], acc[p] = _block_update(
                    qs[p], k_cur[p], v_cur[p], pos, pos, sm_scale, m[p],
                    l[p], acc[p], causal)
        if i != n - 1:
            # shard p hands its block to shard p + 1
            k_cur = [k_cur[p - 1].to(devices[p], non_blocking=True)
                     for p in range(n)]
            v_cur = [v_cur[p - 1].to(devices[p], non_blocking=True)
                     for p in range(n)]
    return [(a / lp.clamp_min(1e-30)).to(q.dtype)
            for a, lp, q in zip(acc, l, qs)]


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
    devices may repeat). ``run`` (``Mesh.run``) runs one program per shard,
    each in its own thread (JAX's ``shard_map``); the programs meet at the
    collective ``ring_attention``, which every shard calls in turn with its
    blocks."""

    def ring_attention(self, p: int, q, k, v,
                       sm_scale: Optional[float] = None, causal: bool = True,
                       impl: Optional[str] = None):
        """The collective: shard p's (B, H, S/n, D) q and (B, Hkv, S/n, D)
        k/v blocks in, its output block out. Every shard must call it; one
        of them runs ``ring_attention_local`` for all n."""
        return self._collective(
            p, (q, k, v), lambda blocks: ring_attention_local(
                *zip(*blocks), sm_scale, causal, impl))
