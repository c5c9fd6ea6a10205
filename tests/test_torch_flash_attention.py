"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, in f32 (rtol/atol 2e-5: the
blockwise online softmax and the dense one sum in different orders)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models.falcon import alibi_slopes
from omniquant_tpu_torch.kernels import flash_attention as tfa
from omniquant_tpu_torch.kernels import tolerance

jfa = importlib.import_module("omniquant_tpu.kernels.flash_attention")


def _qkv(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,alibi", [
    (2, 4, 4, 128, 64, True, False),
    (1, 4, 2, 200, 64, True, False),   # GQA, S no block multiple
    (1, 4, 1, 96, 32, True, True),     # MQA with ALiBi
    (1, 2, 2, 70, 128, False, False),  # not causal, ragged
    (1, 8, 2, 130, 128, True, True),   # GQA with ALiBi, ragged
])
def test_matches_jax_kernel(B, H, Hkv, S, D, causal, alibi):
    q, k, v = _qkv(B, H, Hkv, S, D, seed=S + H)
    slopes = np.array(alibi_slopes(H)) if alibi else None
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=128,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        interpret=True)
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_output_dtype_and_sm_scale():
    q, k, v = _qkv(1, 2, 2, 64, 64, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, sm_scale=0.3)
    assert got.dtype == torch.bfloat16
    want = jfa.flash_attention_reference(
        jnp.asarray(tq.float().numpy()), jnp.asarray(tk.float().numpy()),
        jnp.asarray(tv.float().numpy()), sm_scale=0.3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


def _emulate_cuda_kernel(q, k, v, sm_scale, fault=None, block=64):
    """The CUDA kernel's arithmetic in PyTorch (causal): 64-key tiles, an f32
    online softmax, each unnormalised p rounded to bf16 before p.v, the
    output rounded to bf16. ``fault`` plants a bug: "drop_tile" loses keys
    256..319 for the rows from 512 on (a key tile lost on the long rows),
    "no_rescale" skips the rescale of the output accumulator."""
    B, H, S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, D)
    for j0 in range(0, S, block):
        keys = torch.arange(j0, min(j0 + block, S))[None, :]
        s = qf @ kf[:, :, j0:j0 + block].transpose(-1, -2) * sm_scale
        ok = keys <= rows
        if fault == "drop_tile" and j0 == 256:
            ok = ok & (rows < 512)
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if fault != "no_rescale":
            o = o * alpha
        o = o + p.bfloat16().float() @ vf[:, :, j0:j0 + block]
        m = m_new
    return (o / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_tile", "no_rescale"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The per-element rule the card checks hold the CUDA kernel to admits
    what the kernel rounds (p to bf16 before p.v) and rejects a kernel that
    loses a key tile on the long rows or skips the rescale, at a prompt
    length where late rows' outputs are far below the row-0 magnitudes."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 4, 1024, 128, seed=3))
    scale = 128 ** -0.5
    want = tfa.flash_attention(q, k, v, sm_scale=scale)
    got = _emulate_cuda_kernel(q, k, v, scale, fault)
    ok, _, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(q, k, v, sm_scale=scale))
    assert ok == (fault is None), worst
