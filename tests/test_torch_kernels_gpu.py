"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card. These need a CUDA card and nvcc; without a card they skip. On the
machine with the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not have; nothing here imports JAX.)

Tolerances: the products (quant_matmul, flash_attention,
decode_attention_int8, quant_matmul_int, _quant_matmul_int_dense) round an
f32 sum to bf16 once in both versions, so each element may differ by 2 bf16
ulps of its own size plus the kernel's slack (``kernels/tolerance.py``); the
cache writes and _unpack_to_int8 are copies and must be exact.
"""
import dataclasses
import math

import pytest
import torch

from omniquant_tpu_torch.kernels import decode_attention, kv_update, tolerance
from omniquant_tpu_torch.kernels import quant_matmul as qmm
from omniquant_tpu_torch.kernels.decode_attention import (
    decode_attention_int8, decode_attention_int8_plain,
    decode_attention_launch)
from omniquant_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from omniquant_tpu_torch.kernels.quant_matmul import (
    quant_matmul, quant_matmul_reference)
from omniquant_tpu_torch.models import LLAMA, llama
from omniquant_tpu_torch.models.common import ActQuantSpec
from omniquant_tpu_torch.quant import QuantConfig, pack_weight
from omniquant_tpu_torch.quant.quantizer import fake_quant_act
from omniquant_tpu_torch.serving import LlamaEngine, pack_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(cuda, bits, group_size, out_f, in_f, seed, bias=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(out_f, in_f, generator=gen, device=cuda) * 0.02
    b = torch.randn(out_f, generator=gen, device=cuda) if bias else None
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     bias=b, layout="pairs")
    return pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)


@pytest.mark.parametrize("m", [1, 7, 8, 16, 32, 33, 64, 100, 128, 300,
                               4096])
@pytest.mark.parametrize("bits,group_size,in_f,out_f", [
    (4, 128, 1024, 384), (4, 128, 640, 384), (3, 128, 1280, 384),
    (2, 128, 1024, 384), (4, None, 1024, 384), (3, None, 640, 384),
    (2, 256, 1024, 384), (4, 64, 1024, 384), (2, 64, 1024, 384),
    # per-channel with one pack tile of 160 rows (k_pad not a multiple of
    # 64) and of 80 rows (the prefill tile's 16-column steps)
    (3, None, 160, 384), (3, None, 80, 256),
    # K not a multiple of the 512-row pack tile, several split-K slices
    (4, 128, 1408, 1024),
    # the down projection's K (k_pad 11264 > K: x zero past K)
    (4, 128, 11008, 256)])
def test_quant_matmul_kernel(cuda, bits, group_size, in_f, out_f, m):
    """The kernel's product against the plain one, on the decode tile (m <=
    32) and the prefill tile. With a bias (m = 7 and 100) both versions
    round the product to bf16 and then add the bias in bf16; where the bias
    cancels the product, a one-ulp difference of the product exceeds the
    bound of the small sum. So the product is held to the bound and the
    bias add, done outside the kernel, to exact equality. At m = 4096 the
    weight is 1024 columns wide: a narrower one is dequantized once and
    multiplied by torch.matmul, as the JAX package routes it."""
    out_f = 1024 if m >= 4096 else out_f
    pw = _packed(cuda, bits, group_size, out_f, in_f, seed=bits + m,
                 bias=m in (7, 100))
    gen = torch.Generator(device=cuda).manual_seed(in_f + m)
    x = torch.randn(m, in_f, generator=gen, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches, quant_matmul.launches_prefill
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert (quant_matmul.launches, quant_matmul.launches_prefill) == (
        before[0] + 1, before[1] + (m > 32))
    assert got.dtype == torch.bfloat16 and got.shape == (m, out_f)
    if pw.bias is not None:
        bias = pw.bias
        pw = dataclasses.replace(pw, bias=None)
        product = quant_matmul(x, pw)
        assert torch.equal(got, product + bias.to(torch.bfloat16))
        got = product
    want = quant_matmul_reference(x, pw)
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


@pytest.mark.parametrize("m", [8, 32])
def test_quant_matmul_decode_is_bitwise_repeatable(cuda, m):
    """The decode tile's split-K slices are added in a fixed order, so two
    calls on the same inputs give the same bits."""
    pw = _packed(cuda, 4, 128, 1024, 11008, seed=m)
    plan = qmm.decode_plan(m, 1024, pw.k_pad, pw.tile_k, 128,
                           qmm._sm_count(cuda))
    assert plan.splits > 1
    x = torch.randn(m, 11008, device=cuda).to(torch.bfloat16)
    first = quant_matmul(x, pw)
    second = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("m", [128, 4096, 8192])
@pytest.mark.parametrize("layout,bits,group_size", [
    ("pairs", 4, 128), ("planar", 2, 64)])
def test_quant_matmul_prefill_is_bitwise_repeatable(cuda, layout, bits,
                                                    group_size, m):
    """The prefill tile runs unsplit, so two calls on the same inputs give
    the same bits, and both are held to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(1024, 4096, generator=gen, device=cuda) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout).map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    x = torch.randn(m, 4096, generator=gen, device=cuda).to(torch.bfloat16)
    counts = (quant_matmul.launches_prefill,
              quant_matmul.launches_planar_prefill)
    first = quant_matmul(x, pw)
    second = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert (quant_matmul.launches_prefill - counts[0],
            quant_matmul.launches_planar_prefill - counts[1]) == (
        (2, 0) if layout == "pairs" else (0, 2))
    assert torch.equal(first, second)
    ok, err, worst = tolerance.bf16_close(
        first, quant_matmul_reference(x, pw), tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


def test_quant_matmul_prefill_narrows_its_step_to_fit(cuda):
    """Pairs W2 g128 in 2048-row tiles (128 words per column, 16 groups):
    128-column steps would not fit in shared memory, so the tile takes
    64-column steps, and matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(256, 4096, generator=gen, device=cuda) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=2, group_size=128),
                     layout="pairs", tile_k=2048).map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    assert qmm.prefill_plan("pairs", 2, 2048, 128, 4096).kc == 64
    x = torch.randn(300, 4096, generator=gen, device=cuda).to(torch.bfloat16)
    got = quant_matmul(x, pw)
    ok, err, worst = tolerance.bf16_close(
        got, quant_matmul_reference(x, pw), tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("layout", ["pairs", "planar"])
def test_quant_matmul_kernel_k_not_a_multiple_of_8(cuda, layout, m):
    """in_features 100: x rows are not made of whole 16-byte pieces, so
    both tiles stage x element by element (zero past K) instead of by
    cp.async."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(256, 100, generator=gen, device=cuda) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=4, group_size=None),
                     layout=layout).map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    x = torch.randn(m, 100, generator=gen, device=cuda).to(torch.bfloat16)
    got = quant_matmul(x, pw)
    ok, err, worst = tolerance.bf16_close(
        got, quant_matmul_reference(x, pw), tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


def test_quant_matmul_kernel_refuses_what_it_does_not_take(cuda):
    """f32 x and f32 scales raise; a planar weight (bf16 scales) runs the
    planar kernel and matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(256, 512, generator=gen, device=cuda)
    planar = pack_weight(w, QuantConfig(n_bits=4, group_size=128),
                         layout="planar").map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    x = torch.randn(4, 512, generator=gen, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches_planar_decode
    got = quant_matmul(x, planar)
    torch.cuda.synchronize()
    assert quant_matmul.launches_planar_decode == before + 1
    ok, err, worst = tolerance.bf16_close(
        got, quant_matmul_reference(x, planar), tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)
    pairs = pack_weight(w, QuantConfig(n_bits=4, group_size=128),
                        layout="pairs")
    with pytest.raises(ValueError):
        quant_matmul(x.float(), pairs)
    with pytest.raises(NotImplementedError):  # f32 scales: a bf16 engine
        quant_matmul(x, pairs)                # serves bf16 ones


def _planar(cuda, bits, group_size, out_f, in_f, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(out_f, in_f, generator=gen, device=cuda) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout="planar")
    return pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)


def _planar_case(cuda, bits, group_size, in_f, out_f, m):
    """One planar K1 call against the plain version: its launch counted
    under its tile, and at m <= 32 a second call gives the same bits."""
    pw = _planar(cuda, bits, group_size, out_f, in_f, seed=bits * 100 + m)
    assert pw.layout == "planar"
    gen = torch.Generator(device=cuda).manual_seed(in_f + m)
    x = torch.randn(m, in_f, generator=gen, device=cuda).to(torch.bfloat16)
    counts = (quant_matmul.launches_planar_decode,
              quant_matmul.launches_planar_prefill)
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert (quant_matmul.launches_planar_decode - counts[0],
            quant_matmul.launches_planar_prefill - counts[1]) == (
        (1, 0) if m <= 32 else (0, 1))
    assert got.dtype == torch.bfloat16 and got.shape == (m, out_f)
    want = quant_matmul_reference(x, pw)
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)
    if m <= 32:
        again = quant_matmul(x, pw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.parametrize("m", [1, 7, 8, 16, 32, 33, 64, 100, 128, 300,
                               4096])
@pytest.mark.parametrize("group_size", [32, 64, 128, None])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_quant_matmul_planar_kernel(cuda, bits, group_size, m):
    """Planar K1 at in_features 640 (k_pad 1024: x is zero past 640, the
    groups past in_features reuse the last group's scales); 1024 columns at
    m = 4096, where a narrower weight is dequantized once."""
    _planar_case(cuda, bits, group_size, 640, 1024 if m >= 4096 else 384, m)


@pytest.mark.parametrize("m", [8, 32, 33, 128])
@pytest.mark.parametrize("bits,group_size", [
    (2, 32), (2, 64), (3, 64), (4, 32), (6, 128), (8, None), (3, None)])
def test_quant_matmul_planar_kernel_split_k(cuda, bits, group_size, m):
    """K = 11008 (k_pad 11264, 22 tiles of 512 rows) across several split-K
    slices at m <= 32, summed inside the kernel by the last slice of each
    column block; at g32 a tile holds 16 groups, whose scales ride in the
    ring with the tile's first step."""
    pw = _planar(cuda, bits, group_size, 1024, 11008, seed=1)
    if m <= 32:
        assert _planar_plan(cuda, pw, m).splits > 1
    _planar_case(cuda, bits, group_size, 11008, 1024, m)


def _planar_plan(cuda, pw, m):
    """The planar decode tile's plan for pw at m rows on this card."""
    return qmm.planar_decode_launch(pw, m, cuda)[2]


@pytest.mark.parametrize("K", [4096, 11008, 2688])
@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("group_size", [32, 64, 128, None])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_quant_matmul_planar_decode_tile(cuda, bits, group_size, m, K):
    """The planar decode tile against its plain version at every width and
    group, m up to 32, K = 4096 and 11008 (the 7B widths) and 2688 (not a
    multiple of the 512-row tile: k_pad 3072, x zero past K, the groups
    past K reuse the last); one launch, counted, and two calls give the
    same bits."""
    _planar_case(cuda, bits, group_size, K, 512, m)


def test_quant_matmul_planar_decode_leaves_no_stale_ticket(cuda):
    """The last slice of each column block resets its ticket: a call of
    another shape and split count between two calls of one shape leaves
    the second equal to the first and to the plain version."""
    big = _planar(cuda, 2, 64, 4096, 11008, seed=3)
    small = _planar(cuda, 3, 64, 12288, 4096, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    xb = torch.randn(32, 11008, generator=gen, device=cuda).to(torch.bfloat16)
    xs = torch.randn(8, 4096, generator=gen, device=cuda).to(torch.bfloat16)
    assert _planar_plan(cuda, big, 32).splits != _planar_plan(
        cuda, small, 8).splits
    first = quant_matmul(xb, big)
    between = quant_matmul(xs, small)
    again = quant_matmul(xb, big)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for got, x, pw in ((first, xb, big), (between, xs, small)):
        ok, err, worst = tolerance.bf16_close(
            got, quant_matmul_reference(x, pw), tolerance.QUANT_MATMUL_SLACK)
        assert ok, (err, worst)
    assert int(qmm._K1_TICKETS[cuda.index or 0].abs().sum()) == 0


def test_quant_matmul_planar_decode_one_slice(cuda):
    """A K walk of one step (W2 at K = 512: one 512-row tile) runs as one
    slice, which writes y itself, no workspace and no ticket."""
    pw = _planar(cuda, 2, 64, 4096, 512, seed=6)
    assert _planar_plan(cuda, pw, 32).splits == 1
    _planar_case(cuda, 2, 64, 512, 4096, 32)


def test_quant_matmul_planar_decode_geometry_matches_the_kernel(cuda):
    """The shared memory planar_decode_geometry counts is what the kernel
    asks for, at every width, group and m class."""
    for bits in (2, 3, 4, 6, 8):
        for gs, G in ((32, 128), (64, 64), (128, 32), (4096, 1)):
            for m in (1, 16, 32):
                geo = qmm.planar_decode_geometry(bits, m, 512, gs, G)
                assert qmm._planar_decode_info(bits, m, 512, gs, G,
                                               False) == geo.smem
                assert qmm._planar_ctas(cuda, bits, m, 512, gs, G) >= 2


@pytest.mark.parametrize("m", [1, 32, 33, 300])
@pytest.mark.parametrize("bits,in_f", [(3, 256), (2, 128), (8, 32), (4, 64)])
def test_quant_matmul_planar_small_tile(cuda, bits, in_f, m):
    """A planar tile too small for a decode step (in_features 256 at 3
    bits, 128 at 2, 32 at 8, 64 at 4) runs on the prefill tile at every m;
    its launch counts under its m all the same."""
    pw = _planar(cuda, bits, None, 256, in_f, seed=m)
    assert not qmm._planar_decode(pw)
    _planar_case(cuda, bits, None, in_f, 256, m)


def _flash_inputs(cuda, B, H, Hkv, Sq, Skv, D, alibi, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, Hkv, Skv, D, generator=gen, device=cuda).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, Skv, D, generator=gen, device=cuda).to(
        torch.bfloat16)
    slopes = (2.0 ** (-8.0 * torch.arange(1, H + 1, device=cuda) / H)
              if alibi else None)
    return q, k, v, slopes


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,alibi", [
    (2, 4, 4, 256, 256, 128, True, False),
    (1, 8, 2, 200, 200, 128, True, False),   # GQA, ragged
    (1, 4, 1, 96, 96, 64, True, True),       # MQA, ALiBi, head_dim 64
    (2, 2, 2, 130, 130, 128, False, False),  # not causal, ragged
    (1, 4, 4, 1, 1, 128, True, False),       # a single query
    (2, 32, 32, 1024, 1024, 128, True, False),  # many full tiles, pairs
    (1, 8, 8, 129, 129, 128, True, False),   # one past a 128 edge
    (1, 4, 4, 255, 255, 64, True, False),    # one short of a 128 edge
    (1, 8, 2, 300, 300, 64, True, True),     # ALiBi, GQA, odd tile count
    (1, 4, 4, 70, 300, 128, False, False),   # q and k maps' extents apart
    # Falcon's heads: 7B's 71 on one kv head, 40B's 128 on 8, RW-1B's 32
    # with ALiBi, each at head_dim 64
    (1, 71, 1, 512, 512, 64, True, False),
    (1, 128, 8, 384, 384, 64, True, False),
    (2, 32, 32, 512, 512, 64, True, True),
])
def test_flash_attention_kernel(cuda, B, H, Hkv, Sq, Skv, D, causal, alibi):
    q, k, v, slopes = _flash_inputs(cuda, B, H, Hkv, Sq, Skv, D, alibi,
                                    seed=Sq + Skv)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes)
    want = flash_attention_plain(q, k, v, causal=causal, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ok, err, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(
            q, k, v, causal=causal, alibi_slopes=slopes))
    assert ok, (err, worst)


def test_flash_attention_is_bitwise_repeatable(cuda):
    """No atomics on the output and no split over keys: two calls on the
    same inputs give the same bits."""
    q, k, v, slopes = _flash_inputs(cuda, 2, 8, 2, 640, 640, 128, True, 5)
    a = flash_attention(q, k, v, alibi_slopes=slopes)
    b = flash_attention(q, k, v, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,alibi", [
    # OPT-2.7B's 32 heads of 80 at the opt27b phase's prefill; GQA and
    # ragged; not causal with the maps' extents apart; ALiBi
    (2, 32, 32, 512, 512, 80, True, False),
    (1, 4, 2, 200, 200, 80, True, False),
    (1, 4, 4, 70, 300, 80, False, False),
    (1, 8, 8, 129, 129, 80, True, True),
    # other multiples of 8 on the padded instances
    (1, 4, 4, 256, 256, 96, True, False),
    (1, 4, 1, 130, 130, 40, True, False),
    (1, 2, 2, 64, 64, 8, True, False),
])
def test_flash_attention_kernel_padded_head_dims(cuda, B, H, Hkv, Sq, Skv, D,
                                                 causal, alibi):
    """Head dims other than 64 and 128 run the next instance up, the
    columns past D zero-filled by the loads and clipped by the store:
    against the plain version at the per-element rule, one launch, and the
    output's own memory only (the bytes past it untouched)."""
    q, k, v, slopes = _flash_inputs(cuda, B, H, Hkv, Sq, Skv, D, alibi,
                                    seed=Sq + D)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes)
    want = flash_attention_plain(q, k, v, causal=causal, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (B, H, Sq, D)
    ok, err, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(
            q, k, v, causal=causal, alibi_slopes=slopes))
    assert ok, (err, worst)
    # an output inside a larger buffer: the store leaves the rest alone
    buf = torch.full((got.numel() + 64,), 7.0, dtype=torch.bfloat16,
                     device=cuda)
    out = buf[:got.numel()].view(got.shape)
    real_empty = torch.empty_like
    try:
        torch.empty_like = lambda t, **kw: out if t is q else real_empty(
            t, **kw)
        flash_attention(q, k, v, causal=causal, alibi_slopes=slopes)
    finally:
        torch.empty_like = real_empty
    torch.cuda.synchronize()
    assert torch.equal(out, got) and (buf[got.numel():] == 7.0).all()


@pytest.mark.parametrize("D", [100, 136, 4])
def test_flash_attention_refuses_other_head_dims(cuda, D):
    """A head_dim that is not a multiple of 8 up to 128 raises, naming
    what the kernel takes, before any launch."""
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 2, 64, 64, D, False, 3)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_refuses_misaligned(cuda, which):
    """TMA needs 16-byte aligned tensors: a contiguous view one element
    into its storage raises before any launch."""
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 2, 128, 128, 64, False, 7)
    t = {"q": q, "k": k, "v": v}[which]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    shifted[1:] = t.reshape(-1)
    view = shifted[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    args = {"q": q, "k": k, "v": v, which: view}
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(args["q"], args["k"], args["v"])
    assert flash_attention.launches == before


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,alibi", [
    (1, 32, 32, 2048, 128, True, False),   # the ring's diagonal at sp 2
    (1, 32, 32, 1024, 128, False, False),  # an off-diagonal block at sp 4
    (1, 32, 32, 1024, 80, True, False),    # OPT-2.7B's heads of 80
    (1, 8, 2, 300, 64, False, False),      # GQA, ragged
    (1, 8, 8, 129, 128, True, True),       # ALiBi, one past a 128 edge
    (1, 4, 4, 1, 128, True, False),        # a single query
])
def test_flash_attention_stats_kernel(cuda, B, H, Hkv, S, D, causal, alibi):
    """K2 with its softmax stats against the plain version: out at K2's
    rule and bit for bit the output without stats, m and l at
    tolerance.flash_stats_close; one launch, counted as a stats launch;
    two calls give the same bits."""
    q, k, v, slopes = _flash_inputs(cuda, B, H, Hkv, S, S, D, alibi,
                                    seed=S + D + 1)
    before = (flash_attention.launches, flash_attention.launches_stats)
    out, m, l = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes,
                                return_stats=True)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_stats) == (
        before[0] + 1, before[1] + 1)
    assert m.shape == l.shape == (B, H, S) and m.dtype == torch.float32
    want, m_p, l_p = flash_attention_plain(
        q, k, v, causal=causal, alibi_slopes=slopes, return_stats=True)
    ok, err, worst = tolerance.bf16_close(
        out, want, tolerance.flash_attention_slack(
            q, k, v, causal=causal, alibi_slopes=slopes))
    assert ok, (err, worst)
    ok, dm, rel_l, worst = tolerance.flash_stats_close(m, l, m_p, l_p)
    assert ok, (dm, rel_l, worst)
    alone = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes)
    again = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes,
                            return_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(alone, out)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, m, l)))


@pytest.mark.parametrize("sp", [2, 4])
def test_flash_ring_against_plain_ring(cuda, sp):
    """Ring attention over sp shards on one card (LLaMA-7B's 32 heads of
    128, 2048 tokens): the flash ring (K2 with stats, n(n+1)/2 launches)
    and the plain ring against the plain attention over the whole
    sequence, both at K2's rule; the plain ring launches nothing."""
    from omniquant_tpu_torch.parallel import ring_attention

    q, k, v, _ = _flash_inputs(cuda, 1, 32, 32, 2048, 2048, 128, False, sp)
    want = flash_attention_plain(q, k, v)
    slack = tolerance.flash_attention_slack(q, k, v)
    before = flash_attention.launches_stats
    flash = ring_attention(q, k, v, [cuda] * sp, impl="flash")
    torch.cuda.synchronize()
    assert flash_attention.launches_stats == before + sp * (sp + 1) // 2
    plain = ring_attention(q, k, v, [cuda] * sp, impl="plain")
    torch.cuda.synchronize()
    assert flash_attention.launches_stats == before + sp * (sp + 1) // 2
    for got in (flash, plain):
        ok, err, worst = tolerance.bf16_close(got, want, slack)
        assert ok, (err, worst)


def test_sp_calibrate_on_the_card_matches_the_single_device_run(cuda):
    """calibrate(..., sp_mesh=[cuda] * 2) of a small LLaMA at seqlen 1024
    (W4A16 g128 LWC, 2 epochs of 2 windows): its fp and propagation passes
    through the flash ring (K2 with stats: layers x windows x 2 passes x 3
    launches), its train steps through the plain ring, against the run
    without sp_mesh. The capture passes' bf16 attention moves the targets,
    so the runs drift apart a little: losses within 5e-3 relative, LWC
    factors within 5e-4 rms, and folded weights apart by more than 1e-4 of
    the tensor's largest (a grid step is ~1/15 of a group's range) on at
    most 1e-4 of them; each limit 4-7 times the card's reading (PERF.md,
    PR 21)."""
    import copy

    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.calib import CalibConfig, calibrate

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=4,
                            max_position_embeddings=1024)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = llama.init_params(gen, cfg, dtype=torch.float32, device=cuda)
    tokens = torch.randint(0, 512, (2, 1024), generator=gen, device=cuda)
    cc = CalibConfig(wbits=4, abits=16, group_size=128, lwc=True, epochs=2,
                     nsamples=2)
    runs = []
    for mesh in (None, [cuda] * 2):
        losses = []
        kernels.reset_launch_counts()
        p, omni = calibrate(LLAMA, copy.deepcopy(params), cfg, tokens, cc,
                            device=cuda, sp_mesh=mesh,
                            progress_cb=lambda i, e, x: losses.append(x))
        runs.append((p, omni, losses, kernels.launch_counts()))
    (p1, o1, l1, c1), (p2, o2, l2, c2) = runs
    assert c1["flash_attention_stats"] == 0
    assert c2["flash_attention_stats"] == 2 * 2 * 2 * 3
    assert len(l2) == len(l1) == 4
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    d = torch.cat([(t - o1[i]["lwc"][name][f]).flatten()
                   for i in range(2) for name in LLAMA.linear_names
                   for f, t in o2[i]["lwc"][name].items()])
    lwc_rms = d.pow(2).mean().sqrt().item()
    apart = max(
        ((p2["layers"][i][name]["weight"] - p1["layers"][i][name]["weight"])
         .abs() > 1e-4 * p1["layers"][i][name]["weight"].abs().max())
        .float().mean().item()
        for i in range(2) for name in LLAMA.linear_names)
    readings = dict(loss_gap=loss_gap, lwc_rms=lwc_rms, apart=apart)
    print("sp calibrate on the card against the single-device run:", readings)
    assert loss_gap <= 5e-3, readings
    assert lwc_rms <= 5e-4, readings
    assert apart <= 1e-4, readings


def test_kv_update_kernels_exact(cuda):
    B, H, S, D = 4, 3, 40, 128
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    cache = rnd(B, H, S, D)
    new = rnd(2, H, 24, D)
    slots = torch.tensor([3, 0], dtype=torch.int32, device=cuda)
    a, b = cache.clone(), cache.clone()
    kv_update.kv_cache_prefill_write(a, new, slots)
    kv_update.kv_cache_prefill_write_plain(b, new, slots)
    assert torch.equal(a, b)
    rows = rnd(B, H, D)
    lengths = torch.tensor([0, S - 1, S, 17], dtype=torch.int32, device=cuda)
    before = kv_update.kv_cache_write.launches
    kv_update.kv_cache_write((a,), (rows,), lengths)
    kv_update.kv_cache_write_plain(b, rows, lengths)
    torch.cuda.synchronize()
    assert kv_update.kv_cache_write.launches == before + 1
    assert torch.equal(a, b)  # the row at pos == S was dropped in both
    assert torch.equal(a[2], cache[2])
    # K and V together, as the engine writes them: one launch
    a2, rows2 = rnd(B, H, S, D), rnd(B, H, D)
    b2 = a2.clone()
    kv_update.kv_cache_write((a, a2), (rows2, rows), lengths)
    kv_update.kv_cache_write_plain(b, rows2, lengths)
    kv_update.kv_cache_write_plain(b2, rows, lengths)
    torch.cuda.synchronize()
    assert kv_update.kv_cache_write.launches == before + 2
    assert torch.equal(a, b) and torch.equal(a2, b2)


def _int8_cache(cuda, B, n_kv, S, hd, gen):
    codes = [torch.randint(-127, 128, (B, n_kv, S, hd), generator=gen,
                           device=cuda, dtype=torch.int8) for _ in range(2)]
    scales = [0.001 + 0.019 * torch.rand(B, n_kv, S, generator=gen,
                                         device=cuda) for _ in range(2)]
    return codes[0], scales[0], codes[1], scales[1]


def _decode_inputs(cuda, B, n_kv, n_rep, hd, kv_len, max_len, lengths, R,
                   ring_n, seed):
    """q, cache, lengths and ring for a K6 case; lengths "bounds" puts the
    slots one short of the card's first split, on it, one short of the
    second, and idle (-1)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, n_kv * n_rep, hd, generator=gen, device=cuda).to(
        torch.bfloat16)
    cache = _int8_cache(cuda, B, n_kv, max_len, hd, gen)
    ring = _int8_cache(cuda, B, n_kv, R, hd, gen) if R else None
    if lengths == "bounds":
        per = decode_attention_launch(cuda, kv_len, B, n_kv, n_rep, hd,
                                      R if ring_n >= 0 else 0).per
        lengths = [per - 2, per - 1, 2 * per - 1, -1][:B]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, cache, lens, ring


def _decode_want(q, cache, lens, kv_len, ring, ring_n):
    """The plain version; an idle slot (lengths -1) with no ring attends
    nothing and gets 0, as in the Pallas kernel (the plain version's dense
    softmax over an all-masked row would average the window)."""
    want = decode_attention_int8_plain(q, *cache, lens, kv_len,
                                       q.shape[-1] ** -0.5, ring_kv=ring,
                                       ring_n=ring_n)
    if ring_n < 0:
        want[lens < 0] = 0
    return want


@pytest.mark.parametrize(
    "B,n_kv,n_rep,hd,kv_len,max_len,lengths,R,ring_n", [
        (4, 4, 1, 128, 64, 64, [0, 63, 17, 40], 0, -1),
        (3, 2, 4, 128, 200, 256, [199, 0, 130], 0, -1),  # GQA, ragged window
        (4, 4, 1, 128, 2048, 2048, [1023, 1024, 2000, 37], 0, -1),
        (4, 2, 2, 128, 2048, 2048, [-1, 1024, 2046, 500], 8, 0),  # ring, idle
        (4, 2, 2, 128, 2048, 2048, [-1, 1023, 2040, 129], 8, 7),
        # lengths on the split boundaries, the last slot idle
        (4, 32, 1, 128, 2048, 2048, "bounds", 0, -1),
        (4, 32, 1, 128, 2048, 2048, "bounds", 8, 3),
        (4, 2, 8, 128, 1536, 1536, "bounds", 0, -1),   # n_rep 8
        (4, 2, 8, 128, 1536, 1536, "bounds", 8, 7),
        (4, 4, 1, 64, 1536, 1600, "bounds", 0, -1),    # hd 64
        (4, 2, 3, 64, 1536, 1600, "bounds", 4, 2),
        (4, 2, 1, 64, 512, 512, [-1, 0, 511, 300], 0, -1),
        (2, 4, 5, 64, 300, 300, [-1, 299], 4, 3),
        (32, 32, 1, 128, 256, 512, [-1] + list(range(8, 256, 8)), 0, -1),
        # more than 8 query heads a kv head: head groups of 8, the last
        # part full (Falcon-7B's 71 on one kv head, 40B's 16, 180B's 29)
        (8, 1, 71, 64, 2048, 2048, [1023, 1024, 2047, 0, 1500, 512, 1022,
                                    -1], 0, -1),
        (8, 1, 71, 64, 2048, 2048, [1022, 1023, 2046, -1, 1499, 511, 1021,
                                    -1], 8, 7),
        (32, 1, 71, 64, 256, 512, [-1] + list(range(8, 256, 8)), 0, -1),
        (4, 8, 16, 64, 2048, 2048, "bounds", 8, 3),
        (4, 8, 29, 64, 1536, 1600, "bounds", 0, -1),
        (4, 2, 9, 128, 1000, 1024, [999, 0, -1, 500], 4, 2),
        # a LLaMA-2-70B shard at tp 8: one kv head of 8 query heads, batch
        # 8, a 2048 window, with and without step_n's ring
        (8, 1, 8, 128, 2048, 2048, [2047, 1023, 1024, 0, -1, 1500, 600,
                                    2000], 0, -1),
        (8, 1, 8, 128, 2048, 2048, [2030, 1023, 1024, 0, -1, 1500, 600,
                                    2000], 8, 7),
    ])
def test_decode_attention_int8_kernel(cuda, B, n_kv, n_rep, hd, kv_len,
                                      max_len, lengths, R, ring_n):
    """K6 against its plain version (an idle slot without a ring against 0)
    at hd 128 and 64, 1 to 71 query heads a kv head, windows cut into the
    card's splits with lengths on their boundaries, and the ring; one
    launch, counted."""
    q, cache, lens, ring = _decode_inputs(cuda, B, n_kv, n_rep, hd, kv_len,
                                          max_len, lengths, R, ring_n,
                                          kv_len + R + ring_n + hd + n_rep)
    before = decode_attention_int8.launches
    got = decode_attention_int8(q, *cache, lens, kv_len, hd ** -0.5,
                                ring_kv=ring, ring_n=ring_n)
    want = _decode_want(q, cache, lens, kv_len, ring, ring_n)
    torch.cuda.synchronize()
    assert decode_attention_int8.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.DECODE_ATTENTION_SLACK)
    assert ok, (err, worst)


@pytest.mark.parametrize("kv_len,R,ring_n", [(2048, 0, -1), (2048, 8, 7),
                                             (256, 0, -1)])
def test_decode_attention_int8_is_bitwise_repeatable(cuda, kv_len, R,
                                                     ring_n):
    """The partials merge in split order, not in the order the splits
    finish: two calls on the same inputs give the same bits."""
    q, cache, lens, ring = _decode_inputs(
        cuda, 8, 32, 1, 128, kv_len, kv_len,
        [1023, 1024, 2047, 0, 1500, 512, 1022, -1] if kv_len == 2048
        else [0, 255, 100, 17, 200, 64, 63, -1], R, ring_n, 21)
    args = (q, *cache, lens, kv_len, 128 ** -0.5)
    first = decode_attention_int8(*args, ring_kv=ring, ring_n=ring_n)
    for _ in range(3):
        assert torch.equal(decode_attention_int8(*args, ring_kv=ring,
                                                 ring_n=ring_n), first)


def test_decode_attention_int8_leaves_no_stale_ticket(cuda):
    """The merging split of each (slot, kv head) resets its ticket: a call
    with idle slots and dead splits, then one of another shape and split
    count, then the first again, leave the first two calls' outputs equal,
    every output within its bound and every ticket 0."""
    big = _decode_inputs(cuda, 8, 32, 1, 128, 2048, 2048,
                         [-1, 1024, 2047, 0, -1, 512, 63, 1025], 8, 7, 31)
    small = _decode_inputs(cuda, 4, 8, 4, 128, 1536, 1536, "bounds", 0, -1,
                           32)
    plans = [decode_attention_launch(cuda, kv_len, B, n_kv, n_rep, 128, R)
             for kv_len, B, n_kv, n_rep, R in ((2048, 8, 32, 1, 8),
                                               (1536, 4, 8, 4, 0))]
    assert plans[0].splits != plans[1].splits and plans[0].splits > 1
    ss = 128 ** -0.5
    first = decode_attention_int8(big[0], *big[1], big[2], 2048, ss,
                                  ring_kv=big[3], ring_n=7)
    between = decode_attention_int8(small[0], *small[1], small[2], 1536, ss)
    again = decode_attention_int8(big[0], *big[1], big[2], 2048, ss,
                                  ring_kv=big[3], ring_n=7)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for got, (q, cache, lens, ring), kv_len, ring_n in (
            (first, big, 2048, 7), (between, small, 1536, -1)):
        ok, err, worst = tolerance.bf16_close(
            got, _decode_want(q, cache, lens, kv_len, ring, ring_n),
            tolerance.DECODE_ATTENTION_SLACK)
        assert ok, (err, worst)
    assert int(decode_attention._K6_TICKETS[cuda.index or 0].abs().sum()) == 0


def test_decode_attention_int8_head_groups_leave_no_stale_ticket(cuda):
    """With head groups each (slot, kv head, group) has its own partials
    and ticket: Falcon-7B's 71 query heads on one kv head with the ring,
    then 40B's 16 on 8 kv heads, then the first again: the same bits, both
    within their bound, every ticket 0."""
    mqa = _decode_inputs(cuda, 8, 1, 71, 64, 2048, 2048,
                         [-1, 1024, 2047, 0, -1, 512, 63, 1025], 8, 7, 33)
    gqa = _decode_inputs(cuda, 4, 8, 16, 64, 2048, 2048, "bounds", 0, -1,
                         34)
    assert decode_attention_launch(cuda, 2048, 8, 1, 71, 64, 8).splits > 1
    ss = 64 ** -0.5
    first = decode_attention_int8(mqa[0], *mqa[1], mqa[2], 2048, ss,
                                  ring_kv=mqa[3], ring_n=7)
    between = decode_attention_int8(gqa[0], *gqa[1], gqa[2], 2048, ss)
    again = decode_attention_int8(mqa[0], *mqa[1], mqa[2], 2048, ss,
                                  ring_kv=mqa[3], ring_n=7)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for got, (q, cache, lens, ring), ring_n in ((first, mqa, 7),
                                                (between, gqa, -1)):
        ok, err, worst = tolerance.bf16_close(
            got, _decode_want(q, cache, lens, 2048, ring, ring_n),
            tolerance.DECODE_ATTENTION_SLACK)
        assert ok, (err, worst)
    assert int(decode_attention._K6_TICKETS[cuda.index or 0].abs().sum()) == 0


@pytest.mark.parametrize(
    "B,n_kv,n_rep,kv_len,max_len,lengths,R,ring_n", [
        # OPT-2.7B's 32 kv heads of 80, one query head each: the opt27b
        # phase's decode (8 slots, window 1024 of 1024) and step_n ring
        (8, 32, 1, 1024, 1024, [511, 512, 1023, 0, 600, -1, 127, 128], 0,
         -1),
        (8, 32, 1, 1024, 1024, [510, 511, 1022, -1, 599, -1, 126, 127], 8,
         7),
        (32, 32, 1, 256, 512, [-1] + list(range(8, 256, 8)), 0, -1),
        (4, 32, 1, 2048, 2048, "bounds", 0, -1),
        (4, 32, 1, 2048, 2048, "bounds", 8, 3),
        # GQA and head groups at hd 80
        (4, 4, 2, 1536, 1600, "bounds", 4, 0),
        (3, 2, 4, 300, 300, [299, 0, -1], 0, -1),
        (4, 2, 8, 1536, 1536, "bounds", 8, 7),
        (2, 1, 12, 640, 640, [639, 100], 4, 2),
    ])
def test_decode_attention_int8_kernel_hd80(cuda, B, n_kv, n_rep, kv_len,
                                           max_len, lengths, R, ring_n):
    """K6 at head_dim 80 (chunks of 128 rows, one lane a K row, 20 lanes a
    V row) against its plain version, with the ring and idle slots, at 1
    to 12 query heads a kv head; one launch, and the same bits twice."""
    hd = 80
    q, cache, lens, ring = _decode_inputs(cuda, B, n_kv, n_rep, hd, kv_len,
                                          max_len, lengths, R, ring_n,
                                          kv_len + R + ring_n + n_rep)
    before = decode_attention_int8.launches
    got = decode_attention_int8(q, *cache, lens, kv_len, hd ** -0.5,
                                ring_kv=ring, ring_n=ring_n)
    again = decode_attention_int8(q, *cache, lens, kv_len, hd ** -0.5,
                                  ring_kv=ring, ring_n=ring_n)
    want = _decode_want(q, cache, lens, kv_len, ring, ring_n)
    torch.cuda.synchronize()
    assert decode_attention_int8.launches == before + 2
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.DECODE_ATTENTION_SLACK)
    assert ok, (err, worst)


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_decode_geometry_matches_the_kernel(cuda, hd):
    """decode_geometry's shared memory is the kernel's (Geo<HD, REP>, as
    decode_attention_info reports it) for every instance."""
    for rep in (1, 2, 4, 8):
        assert (decode_attention.decode_geometry(hd, rep).smem
                == decode_attention._decode_info(hd, rep, False)), rep


@pytest.mark.parametrize("hd", [96, 72, 48])
def test_decode_attention_int8_refuses_other_head_dims(cuda, hd):
    """A head_dim without an instance raises, naming the ones there are,
    before any launch."""
    q, cache, lens, _ = _decode_inputs(cuda, 2, 2, 1, hd, 64, 64, [10, 63],
                                       0, -1, 5)
    before = decode_attention_int8.launches
    with pytest.raises(ValueError, match="64, 80 or 128"):
        decode_attention_int8(q, *cache, lens, 64, hd ** -0.5)
    assert decode_attention_int8.launches == before


def test_decode_attention_int8_is_one_launch(cuda):
    """One call of a split window with a ring runs one kernel on the card:
    no memset of the tickets, no second pass to merge the splits."""
    from torch.profiler import ProfilerActivity, profile

    q, cache, lens, ring = _decode_inputs(
        cuda, 8, 32, 1, 128, 2048, 2048,
        [1023, 1024, 2047, 0, 1500, 512, 1022, -1], 8, 7, 41)
    args = (q, *cache, lens, 2048, 128 ** -0.5)
    assert decode_attention_launch(cuda, 2048, 8, 32, 1, 128, 8).splits > 1
    decode_attention_int8(*args, ring_kv=ring, ring_n=7)  # workspace made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_attention_int8(*args, ring_kv=ring, ring_n=7)
        torch.cuda.synchronize()
    # every event goes into the message, so a failure says what the trace
    # held beside (or instead of) the kernel
    events = [(e.key, e.device_type.name, e.count)
              for e in prof.key_averages()]
    on_card = [(k, n) for k, d, n in events if d == "CUDA"]
    assert len(on_card) == 1 and on_card[0][1] == 1, events
    assert "decode_attn_kernel" in on_card[0][0], events


def _offset_view(t, offset_bytes):
    """A contiguous copy of ``t`` whose address is ``offset_bytes`` past a
    16-byte boundary."""
    n = offset_bytes // t.element_size()
    flat = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    view = flat[n:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset_bytes
    return view


def _kv_write_exact(bufs, news, lengths, span):
    """K4 (span 1) or K5 on ``bufs`` against the plain span write: exact,
    one launch."""
    plain = [b.clone() for b in bufs]
    for p, n in zip(plain, news):
        kv_update.kv_cache_write_span_plain(p, n, lengths)
    if span == 1:
        before = kv_update.kv_cache_write.launches
        kv_update.kv_cache_write(bufs, [n[:, :, 0] for n in news], lengths)
        count = kv_update.kv_cache_write.launches - before
    else:
        before = kv_update.kv_cache_write_span.launches
        kv_update.kv_cache_write_span(bufs, news, lengths)
        count = kv_update.kv_cache_write_span.launches - before
    torch.cuda.synchronize()
    assert count == 1
    for got, want in zip(bufs, plain):
        assert torch.equal(got, want)


@pytest.mark.parametrize("span", [1, 3, 8])
def test_kv_write_mixed_kinds_and_span_exact(cuda, span):
    """K4 (span 1) and K5 write int8 codes, bf16 rows and f32 scale planes
    of mixed row sizes in one launch each, exactly as their plain
    versions; rows past the cache or before it are dropped, and a span
    that crosses the cache's end is cut there. Then hd 64 rows (int8 and
    bf16) and a plane from sources whose addresses force units of 1, 2 and
    8 bytes."""
    B, H, S, D = 6, 3, 40, 128
    gen = torch.Generator(device=cuda).manual_seed(span)
    kc, ks, vc, vs = _int8_cache(cuda, B, H, S, D, gen)
    vb = torch.randn(B, H, S, D, generator=gen, device=cuda).to(
        torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=cuda,
                             dtype=torch.int8)

    def bf16(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    news = (codes(B, H, span, D), bf16(B, H, span, D),
            torch.rand(B, H, span, generator=gen, device=cuda),
            torch.rand(B, H, span, generator=gen, device=cuda))
    lengths = torch.tensor([0, S - 2, -1, 17, S, S - 1], dtype=torch.int32,
                           device=cuda)
    _kv_write_exact((kc, vb, ks, vs), news, lengths, span)
    # hd 64 caches; sources 1, 2 and 8 bytes past a 16-byte boundary
    c64, b64 = codes(B, H, S, 64), bf16(B, H, S, 64)
    plane = torch.rand(B, H, S, generator=gen, device=cuda)
    news = (_offset_view(codes(B, H, span, 64), 1),
            _offset_view(bf16(B, H, span, 64), 2),
            _offset_view(codes(B, H, span, 64), 8),
            torch.rand(B, H, span, generator=gen, device=cuda))
    _kv_write_exact((c64, b64, codes(B, H, S, 64), plane), news, lengths,
                    span)


def test_kv_writes_do_not_synchronize(cuda):
    """K4 and K5 calls with int32 lengths on the card queue their launch
    without a host synchronisation."""
    B, H, S, D = 4, 2, 32, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    bufs = _int8_cache(cuda, B, H, S, D, gen)
    bufs = (bufs[0], bufs[2], bufs[1], bufs[3])
    rows = (torch.zeros(B, H, D, dtype=torch.int8, device=cuda),
            torch.zeros(B, H, D, dtype=torch.int8, device=cuda),
            torch.ones(B, H, device=cuda), torch.ones(B, H, device=cuda))
    spans = tuple(torch.stack([r] * 4, dim=2) for r in rows)
    lengths = torch.tensor([0, 5, S - 2, S], dtype=torch.int32, device=cuda)
    kv_update.kv_cache_write(bufs, rows, lengths)  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kv_update.kv_cache_write(bufs, rows, lengths)
        kv_update.kv_cache_write_span(bufs, spans, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_int8_engine_on_the_card_matches_plain_versions(cuda):
    """A tiny bf16 int8-KV engine on the card (K3, K5 through a verify
    pass on fixed tokens, then K4 on codes and planes and K6) against the
    same engine on the CPU (every plain version): the decode logits after
    the verified tokens are accepted. A staged step_n (the ring and its
    flush) must then give tokens in the vocabulary."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    gen = torch.Generator().manual_seed(1)
    dense = llama.init_params(gen, cfg, device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    reqs = [[(5 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                          dtype=torch.bfloat16, kv_dtype="int8", device=dev)
        slots = eng.add_requests(reqs)
        eng.verify_step({s: [3 + s, 7, 11, 13] for s in slots})
        eng.lengths[slots] += 4
        toks, lens = eng._device_tokens({s: 1 for s in slots})
        logits.append(eng._decode_impl(toks, lens, eng._kv_len(1))[
            :len(slots)].float().cpu())
        out = eng.step_n({s: 2 for s in slots}, 4)
        assert all(0 <= t < 256 for ts in out.values() for t in ts)
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 3e-2


def test_int8_decode_does_not_synchronize(cuda):
    """The int8 decode step, the staged step_n and the verify pass queue
    their work without a host synchronisation inside the layer loop."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    dense = llama.init_params(torch.Generator().manual_seed(2), cfg,
                              device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                      dtype=torch.bfloat16, kv_dtype="int8", device=cuda)
    slots = eng.add_requests([[1, 2, 3, 4, 5], [6, 7, 8]])
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    verify = torch.full((4, 3), 5, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_impl(toks, lens, 64)
        eng._decode_multi_impl(toks, lens + 1, 64, 4, False)
        eng._verify_impl(verify, lens + 5, 64, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_planar_engine_on_the_card_matches_plain_versions(cuda):
    """A tiny W2A16 g64 bf16 engine (pack_model's auto layout: planar) on
    the card (planar K1 at m <= 32 and m > 32) against the same engine on
    the CPU (every plain version): prefill logits within 3e-2 rms, and the
    greedy tokens of a batched prefill and step_n(., 4) equal."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    dense = llama.init_params(torch.Generator().manual_seed(6), cfg,
                              device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=2, group_size=64),
                        device="cpu")
    assert packed["layers"][0]["q_proj"].layout == "planar"
    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits, tokens = [], []
    for dev in ("cpu", "cuda"):
        eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                          dtype=torch.bfloat16, device=dev)
        counts = (quant_matmul.launches_planar_decode,
                  quant_matmul.launches_planar_prefill)
        slots, lg = eng.add_requests(reqs, return_logits=True)
        logits.append(lg.float().cpu())
        first = [eng._pending_next[s] for s in slots]
        out = eng.step_n(dict(zip(slots, first)), 4)
        tokens.append(first + [t for s in slots for t in out[s]])
        if dev == "cuda":
            assert quant_matmul.launches_planar_decode > counts[0]
            assert quant_matmul.launches_planar_prefill > counts[1]
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 3e-2
    assert tokens[1] == tokens[0]


def test_engine_on_the_card_matches_plain_versions(cuda):
    """A tiny bf16 engine on the card (every kernel) against the same engine
    on the CPU (every plain version): prefill logits, dense and flash."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    gen = torch.Generator().manual_seed(0)
    dense = llama.init_params(gen, cfg, device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                          dtype=torch.bfloat16, flash_min_len=32, device=dev)
        _, lg = eng.add_requests(reqs, return_logits=True)
        logits.append(lg.float().cpu())
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 3e-2


# ---------------------------------------------------------------------------
# K1 at the per-shard shapes of tensor-parallel serving

# (label, bits, group, layout, N, K, tp, padded K): a column-parallel weight
# packed whole, padded (pad_intermediate_packed), made splittable
# (_ensure_col_splittable: OPT-2.7B's out_proj retiles from 512 rows to 256
# at tp 2 and 128 at tp 4) and split; shard 0 against the plain version. A
# row-parallel shard is a pack of its own lanes: the 70B fused qkv (1280
# lanes a shard at tp 8) and gate_up (2 x 3584).
TP_K1 = [
    ("70b o tp8", 3, 128, "planar", 8192, 8192, 8, 8192),
    ("70b down tp8", 3, 128, "planar", 8192, 28672, 8, 28672),
    ("70b qkv tp8", 3, 128, "pairs", 1280, 8192, 1, 8192),
    ("70b gate_up tp8", 3, 128, "pairs", 7168, 8192, 1, 8192),
    ("7b down tp2", 4, 128, "pairs", 4096, 11008, 2, 11264),
    ("7b o tp2", 4, 128, "pairs", 4096, 4096, 2, 4096),
    ("opt27b out tp2 (tile 256)", 4, 128, "pairs", 2560, 2560, 2, 2560),
    ("opt27b out tp4 (tile 128)", 4, 128, "pairs", 2560, 2560, 4, 2560),
]


def tp_shard_weight(device, bits, group_size, layout, N, K, tp, k_pad,
                    seed=0):
    """Shard 0 of a (N, K) weight placed column-parallel over tp shards, as
    the TP engine places it, with bf16 scales and zeros."""
    from omniquant_tpu_torch.parallel import tp_forward as tpf
    from omniquant_tpu_torch.parallel.sharding import local_packed

    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout)
    del w
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    if k_pad != K:
        pw = tpf._pad_packed_in(pw, k_pad)
    pw = tpf._ensure_col_splittable(pw, tp)
    return local_packed(pw, tpf.local_spec(pw, False), tp, 0, device)


@pytest.mark.parametrize("m", [1, 8, 40, 128])
@pytest.mark.parametrize("label,bits,group_size,layout,N,K,tp,k_pad", TP_K1)
def test_quant_matmul_kernel_tp_shards(cuda, label, bits, group_size, layout,
                                       N, K, tp, k_pad, m):
    """K1 on the tiles and shapes tensor-parallel placement makes (retiled
    tiles included), against its plain version; one launch, never the dense
    route."""
    pw = tp_shard_weight(cuda, bits, group_size, layout, N, K, tp, k_pad)
    if "tile" in label:
        assert pw.tile_k == int(label.split("tile ")[1].rstrip(")"))
    x = torch.randn(m, k_pad // tp, generator=torch.Generator(
        device=cuda).manual_seed(m), device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    ok, err, worst = tolerance.bf16_close(got, quant_matmul_reference(x, pw),
                                          tolerance.QUANT_MATMUL_SLACK)
    assert ok, (label, err, worst)


def test_tp_engine_on_the_card_matches_single(cuda):
    """A tiny packed LLaMA served by TPLlamaEngine over 4 shards on one card
    (bf16, int8 KV: K1, K2, K3, K4, K5, K6 on every shard) against the
    single engine on the card: prefill logits near each other, every kernel
    launched by every shard."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.parallel import make_mesh
    from omniquant_tpu_torch.serving import TPLlamaEngine

    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=4)
    gen = torch.Generator().manual_seed(0)
    dense = llama.init_params(gen, cfg, device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    kw = dict(max_batch=4, max_len=128, dtype=torch.bfloat16,
              flash_min_len=32, kv_dtype="int8")
    single = LlamaEngine(packed, cfg, device=cuda, **kw)
    tp = TPLlamaEngine(packed, cfg, make_mesh(tp=4, devices=[cuda] * 4), **kw)
    logits, streams = [], []
    for eng in (single, tp):
        kernels.reset_launch_counts()
        slots, lg = eng.add_requests(reqs, return_logits=True)
        logits.append(lg.float().cpu())
        last = {s: eng._pending_next[s] for s in slots}
        streams.append(eng.step_n(last, 4))
        counts = kernels.launch_counts()
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 3e-2
    for name in ("quant_matmul", "flash_attention", "kv_cache_prefill_write",
                 "kv_cache_write_span", "decode_attention_int8"):
        assert counts[name] > 0, name
    # every shard launches its own: 4 shards x 2 layers x 4 steps of K6
    assert counts["decode_attention_int8"] == 4 * 2 * 4


# ---------------------------------------------------------------------------
# the integer-activation path: K7, K8, K9


def _int_packed(cuda, bits, group_size, out_f, in_f, layout, seed,
                tile_k=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(out_f, in_f, generator=gen, device=cuda) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout, tile_k=tile_k)
    return pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)


@pytest.mark.parametrize("bits,group_size,layout", [
    (2, 128, "planar"), (3, 128, "planar"), (4, 64, "planar"),
    (6, 128, "planar"), (6, None, "planar"), (8, None, "planar"),
    (2, None, "pairs"), (3, 128, "pairs"), (4, 128, "pairs")])
def test_unpack_to_int8_kernel_exact(cuda, bits, group_size, layout):
    """K8 equals its plain version for every width and layout, with K
    (1100 or 1152) padded up to the pack tile."""
    in_f = 1152 if group_size else 1100  # both pad up to the pack tile
    pw = _int_packed(cuda, bits, group_size, 384, in_f, layout, seed=bits)
    before = qmm._unpack_to_int8.launches
    got = qmm._unpack_to_int8(pw)
    want = qmm.unpack_to_int8_plain(pw)
    torch.cuda.synchronize()
    assert qmm._unpack_to_int8.launches == before + 1
    assert got.shape == (384, pw.k_pad) and torch.equal(got, want)


@pytest.mark.parametrize("bits,group_size,layout,out_f,in_f,tile_k", [
    (4, 128, "pairs", 12288, 4096, None), (4, 128, "pairs", 4096, 11008,
                                           None),
    (6, 128, "planar", 22016, 4096, None), (2, 64, "planar", 4096, 11008,
                                            None),
    (4, 64, "planar", 256, 1088, 64), (4, None, "planar", 256, 960, 320)])
def test_unpack_to_int8_kernel_k_major_widths(cuda, bits, group_size,
                                              layout, out_f, in_f, tile_k):
    """K8's K-major codes (N, k_pad) equal its plain version at the 7B
    widths (qkv, down, gate_up) and on pack tiles of 64 and 320 rows
    (k_pad % 128 == 64)."""
    pw = _int_packed(cuda, bits, group_size, out_f, in_f, layout, seed=bits,
                     tile_k=tile_k)
    got = qmm._unpack_to_int8(pw)
    want = qmm.unpack_to_int8_plain(pw)
    torch.cuda.synchronize()
    assert got.shape == (out_f, pw.k_pad) and torch.equal(got, want)


def _int_check(got, x, pw, cfg, w8=None):
    xc, xs = qmm.quantize_act_int(x.reshape(-1, x.shape[-1]), cfg)
    w8 = qmm.unpack_to_int8_plain(pw) if w8 is None else w8
    want, mag = qmm.quant_matmul_int_dense_plain(xc, xs, w8, pw,
                                                 magnitude=True)
    ok, err, worst = tolerance.bf16_close(got.reshape(want.shape), want,
                                          tolerance.INT_MATMUL_SLACK * mag)
    assert ok, (err, worst)


@pytest.mark.parametrize("m", [1, 8, 31, 32, 33, 128, 300, 2047, 2048])
@pytest.mark.parametrize("bits,group_size,abits", [
    (6, 128, 6), (4, 64, 4), (2, 128, 4), (3, 128, 6), (8, None, 4),
    (6, None, 6)])
def test_quant_matmul_int_kernels(cuda, bits, group_size, abits, m):
    """quant_matmul_int on planar weights: below 2048 rows one K7 launch
    (n8 tiles of 1, 2, 4, 8 and 16 token rows, row blocks past 128; W3's
    16-word blocks on K7's generic path), from 2048 rows K8 + K9; each
    against its plain version (K = 1100 or 1152, padded up to the pack
    tile)."""
    in_f = 1152 if group_size else 1100  # both pad up to the pack tile
    pw = _int_packed(cuda, bits, group_size, 384, in_f, "planar",
                     seed=bits + m)
    cfg = QuantConfig(n_bits=abits)
    x = torch.randn(m, in_f, device=cuda).to(torch.bfloat16)
    counts = (qmm.quant_matmul_int.launches, qmm._unpack_to_int8.launches,
              qmm._quant_matmul_int_dense.launches)
    got = qmm.quant_matmul_int(x, pw, cfg)
    torch.cuda.synchronize()
    dense = m >= 2048
    assert (qmm.quant_matmul_int.launches - counts[0],
            qmm._unpack_to_int8.launches - counts[1],
            qmm._quant_matmul_int_dense.launches - counts[2]) == (
        (0, 1, 1) if dense else (1, 0, 0))
    assert got.dtype == torch.bfloat16 and got.shape == (m, 384)
    _int_check(got, x, pw, cfg)


@pytest.mark.parametrize("m", [1, 32, 128, 300])
@pytest.mark.parametrize("bits,group_size,in_f,tile_k,K", [
    (6, 128, 1024, None, 1000), (4, 64, 1024, None, 1000),
    (4, 64, 1280, 320, 1280), (2, 64, 384, 192, 384),
    (6, 64, 128, None, 120), (3, None, 1024, 1024, 1016),
    (8, 64, 1024, 512, 1024), (4, 64, 2048, 1024, 2000),
    (8, 128, 2048, 1024, 2048)])
def test_quant_matmul_int_kernel_tiles(cuda, bits, group_size, in_f, tile_k,
                                       K, m):
    """K7 at K not a multiple of 16 (x_vec off, rows past K zero), on the
    pack tiles of its generic path (low blocks of 40, 12 and 8 words), a
    fast 3-bit tile of 1024 rows, and fast tiles whose low blocks are
    longer than a group (W8 g64 at 512 rows, W4 g64 and W8 g128 at 1024:
    a step's k32 blocks each in a group of its own), each against its
    plain version."""
    pw = _int_packed(cuda, bits, group_size, 256, in_f, "planar", seed=m,
                     tile_k=tile_k)
    cfg = QuantConfig(n_bits=6)
    x = torch.randn(m, K, device=cuda).to(torch.bfloat16)
    before = qmm.quant_matmul_int.launches
    got = qmm.quant_matmul_int(x, pw, cfg)
    torch.cuda.synchronize()
    assert qmm.quant_matmul_int.launches == before + 1
    _int_check(got, x, pw, cfg)


@pytest.mark.parametrize("m", [1, 32, 128, 300])
@pytest.mark.parametrize("bits,group_size,in_f,tile_k,K", [
    (6, 128, 4096, None, 4096), (8, 64, 1024, 512, 1000),
    (2, None, 1100, None, 1100)])
def test_quant_matmul_int_generic_path(cuda, bits, group_size, in_f, tile_k,
                                       K, m):
    """K7's generic path forced on tiles the fast path takes (as
    chip_smoke.py times it), against the plain version."""
    pw = _int_packed(cuda, bits, group_size, 256, in_f, "planar", seed=m,
                     tile_k=tile_k)
    cfg = QuantConfig(n_bits=6)
    x = torch.randn(m, K, device=cuda).to(torch.bfloat16)
    xc, xs = qmm.quantize_act_int(x, cfg)
    got = qmm._qmm_int_cuda(xc, xs, pw, torch.bfloat16, generic=True)
    torch.cuda.synchronize()
    _int_check(got, x, pw, cfg)


@pytest.mark.parametrize("m", [8, 32, 128, 300])
@pytest.mark.parametrize("in_f,out_f", [(11008, 4096), (4096, 12288)])
def test_quant_matmul_int_is_bitwise_repeatable(cuda, in_f, out_f, m):
    """K7 at the 7B down and qkv widths (W6 g128; split-K at down): two
    calls give equal bits, and match the plain version."""
    pw = _int_packed(cuda, 6, 128, out_f, in_f, "planar", seed=m)
    cfg = QuantConfig(n_bits=6)
    x = torch.randn(m, in_f, device=cuda).to(torch.bfloat16)
    a = qmm.quant_matmul_int(x, pw, cfg)
    b = qmm.quant_matmul_int(x, pw, cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _int_check(a, x, pw, cfg)


@pytest.mark.parametrize("m", [1, 33, 300])
@pytest.mark.parametrize("bits,group_size,layout", [
    (4, 128, "pairs"), (4, None, "pairs"), (3, 128, "pairs"),
    (6, 128, "planar"), (2, 64, "planar")])
def test_quant_matmul_int_dense_kernel(cuda, bits, group_size, layout, m):
    """K9 called directly (through _quant_matmul_int_dense, as the JAX tests
    call the dense route) at small and ragged m, with a bias."""
    in_f = 1152 if group_size else 1100  # both pad up to the pack tile
    pw = _int_packed(cuda, bits, group_size, 256, in_f, layout, seed=m)
    bias = torch.randn(256, device=cuda).to(torch.bfloat16)
    pw.bias = bias
    cfg = QuantConfig(n_bits=4)
    x = torch.randn(m, in_f, device=cuda).to(torch.bfloat16)
    before = qmm._quant_matmul_int_dense.launches
    got = qmm._quant_matmul_int_dense(x, pw, cfg)
    torch.cuda.synchronize()
    assert qmm._quant_matmul_int_dense.launches == before + 1
    pw.bias = None
    nobias = qmm._quant_matmul_int_dense(x, pw, cfg)
    _int_check(nobias, x, pw, cfg)
    assert torch.equal(got, nobias + bias)  # added after, in bf16


def _k9_case(cuda, pw, m, abits=4):
    """K9 alone on one x against its plain version; returns the output."""
    cfg = QuantConfig(n_bits=abits)
    x = torch.randn(m, pw.in_features, device=cuda).to(torch.bfloat16)
    xc, xs = qmm.quantize_act_int(x, cfg)
    w8 = qmm._unpack_to_int8(pw)
    got = qmm._qmm_int_dense_cuda(xc, xs, w8, pw, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (m, pw.qweight.shape[1])
    _int_check(got, x, pw, cfg, w8)
    return got


@pytest.mark.parametrize("m", [64, 128, 2100, 4096])
@pytest.mark.parametrize("in_f,out_f", [(4096, 12288), (11008, 4096)])
def test_int_dense_kernel_7b_widths(cuda, in_f, out_f, m):
    """K9 at the 7B qkv and down widths (W4 g128 pairs, 4-bit codes; down
    pads K = 11008 to 11264) at small, ragged (2100) and prefill rows."""
    pw = _int_packed(cuda, 4, 128, out_f, in_f, "pairs", seed=m)
    _k9_case(cuda, pw, m)


@pytest.mark.parametrize("m", [300, 4096])
@pytest.mark.parametrize("bits,group_size,layout,in_f,tile_k,abits", [
    (4, None, "pairs", 4096, None, 4), (8, None, "planar", 1100, None, 4),
    (4, 64, "planar", 4096, None, 4), (6, 128, "planar", 4096, None, 6),
    (4, 64, "planar", 1088, 64, 4), (4, None, "planar", 960, 320, 6)])
def test_int_dense_kernel_groups(cuda, bits, group_size, layout, in_f,
                                 tile_k, abits, m):
    """K9 on every kind of group: per channel (a group per pack tile of
    512 rows; W8's dots exceed 2^22, so the kernel converts them with cvt),
    W4 planar g64 (two closes a stage), W6 planar g128, k_pad % 128 == 64
    (a half stage at the end, g64 on 64-row tiles) and per-channel groups
    of 320 rows (closing inside a stage)."""
    pw = _int_packed(cuda, bits, group_size, 1024, in_f, layout, seed=bits,
                     tile_k=tile_k)
    if tile_k:
        assert pw.k_pad % 128 == 64
    _k9_case(cuda, pw, m, abits)


@pytest.mark.parametrize("m", [4096, 8192])
def test_int_dense_kernel_is_bitwise_repeatable(cuda, m):
    """Two K9 calls on the same codes give equal bits (no atomics, a fixed
    order of every sum)."""
    pw = _int_packed(cuda, 4, 128, 12288, 4096, "pairs", seed=1)
    x = torch.randn(m, 4096, device=cuda).to(torch.bfloat16)
    xc, xs = qmm.quantize_act_int(x, QuantConfig(n_bits=4))
    w8 = qmm._unpack_to_int8(pw)
    a = qmm._qmm_int_dense_cuda(xc, xs, w8, pw, torch.bfloat16)
    b = qmm._qmm_int_dense_cuda(xc, xs, w8, pw, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_ineligible_int_calls_raise_on_the_card(cuda):
    """A planar weight whose call cannot take the integer kernels (8-bit or
    grouped activation quantizers, N % 128 != 0) takes fake-quantized
    activations into planar K1 (or, at odd N, the dense reference, as in
    JAX) and matches that plain path. K7 and K9 on groups of 32 rows raise:
    they take groups of a multiple of 64."""
    x = torch.randn(4, 256, device=cuda).to(torch.bfloat16)
    pw = _int_packed(cuda, 4, 128, 256, 256, "planar", seed=0)
    odd = _int_packed(cuda, 4, 128, 192, 256, "planar", seed=1)
    g32 = _int_packed(cuda, 6, 32, 256, 256, "planar", seed=2)
    for w, cfg in ((pw, QuantConfig(n_bits=8)),
                   (pw, QuantConfig(n_bits=4, group_size=128)),
                   (odd, QuantConfig(n_bits=4))):
        assert qmm.int_route(4, w, cfg) == "fake_quant"
        got = qmm.quant_matmul_int(x, w, cfg)
        want = quant_matmul_reference(fake_quant_act(x, cfg), w)
        torch.cuda.synchronize()
        ok, err, worst = tolerance.bf16_close(got, want,
                                              tolerance.QUANT_MATMUL_SLACK)
        assert ok, (err, worst)
    with pytest.raises(NotImplementedError):
        qmm.quant_matmul_int(x, g32, QuantConfig(n_bits=6))
    with pytest.raises(NotImplementedError):
        qmm._quant_matmul_int_dense(x, g32, QuantConfig(n_bits=6))


def _tiny_int_engine(dev, abits, seed, monkeypatch, **kw):
    """A tiny W4A4 (pairs) or W6A6 (planar) bf16 engine whose prefill takes
    the dense integer route (from 16 rows on)."""
    monkeypatch.setattr(qmm, "_INT_DENSE_MIN_M", 16)
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    dense = llama.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
    wbits = 4 if abits == 4 else 6
    packed = pack_model(LLAMA, dense,
                        QuantConfig(n_bits=wbits, group_size=128),
                        device="cpu")
    return LlamaEngine(packed, cfg, dtype=torch.bfloat16,
                       spec=ActQuantSpec.from_bits(abits), device=dev, **kw)


@pytest.mark.parametrize("abits", [4, 6])
def test_int_decode_does_not_synchronize(cuda, monkeypatch, abits):
    """The W4A4 and W6A6 decode step, step_n and the verify pass queue their
    work (activation quantizers, K1 or K7) without a host synchronisation
    inside the layer loop."""
    eng = _tiny_int_engine(cuda, abits, 3, monkeypatch, max_batch=4,
                           max_len=128)
    slots = eng.add_requests([[1, 2, 3, 4, 5], [6, 7, 8]])
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    verify = torch.full((4, 3), 5, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_impl(toks, lens, 64)
        eng._decode_multi_impl(toks, lens + 1, 64, 4, False)
        eng._verify_impl(verify, lens + 5, 64, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("abits", [4, 6])
def test_int_engine_on_the_card_matches_plain_versions(cuda, monkeypatch,
                                                       abits):
    """A tiny W4A4 / W6A6 bf16 engine on the card (K8 + K9 at prefill, K1 or
    K7 at decode) against the same engine on the CPU (every plain version):
    the prefill logits and the first decode logits. The two round bf16
    activations in other orders, and a 4-bit activation code may flip on
    that, so the bound is on the rms error (5e-2 of the logits' rms)."""
    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = _tiny_int_engine(dev, abits, 4, monkeypatch, max_batch=4,
                               max_len=128)
        before = qmm._quant_matmul_int_dense.launches
        slots, lg = eng.add_requests(reqs, return_logits=True)
        toks, lens = eng._device_tokens({s: 1 for s in slots})
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))[:len(slots)]
        logits.append(torch.cat([lg.float().cpu(), dec.float().cpu()]))
        if dev == "cuda":
            assert qmm._quant_matmul_int_dense.launches > before
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 5e-2


def _calib_one_step(dev, let, abits, group_size, epochs=1):
    """calib/engine.py::calibrate of a small GQA LLaMA block on ``dev``,
    one window of 128 tokens (one step an epoch; epochs=0: the start).
    Returns (its loss, the trainables), on the CPU."""
    from omniquant_tpu_torch.calib import (
        CalibConfig, calibrate, collect_act_stats)

    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=1,
                            num_attention_heads=4, num_key_value_heads=2)
    params = llama.init_params(torch.Generator().manual_seed(5), cfg,
                               device="cpu")
    tokens = (torch.arange(128) * 7 % 256)[None]
    stats = (collect_act_stats(LLAMA, params, cfg, tokens, device=dev)
             if let else (None, None))
    losses = []
    _, omni = calibrate(
        LLAMA, params, cfg, tokens,
        CalibConfig(wbits=4, abits=abits, group_size=group_size, lwc=True,
                    let=let, nsamples=1, epochs=epochs),
        *stats, progress_cb=lambda i, e, l: losses.append(l), device=dev)
    groups = {g: [t.cpu() for t in (
        [x for v in omni[0][g].values() for x in v.values()] if g == "lwc"
        else omni[0][g].values())] for g in ("let", "lwc") if g in omni[0]}
    return losses, groups


@pytest.mark.parametrize("let,abits,group_size,tol", [
    (False, 16, 128, dict(loss=1e-5, step=1e-4)),
    (True, 16, 128, dict(loss=1e-5, step=1e-4)),
    (True, 4, None, dict(loss=1e-3, step=5e-2)),
])
def test_calibration_step_on_the_card_matches_cpu(cuda, monkeypatch, let,
                                                  abits, group_size, tol):
    """One step of calibrate, LWC (W4A16 g128) or LET + LWC (W4A16 g128,
    W4A4 per-channel), on the card against the same on the CPU, in f32
    with TF32 off: the loss, relative (``tol['loss']``), and each group's
    displacement from its start (every trainable of the group in one
    vector), the norm of the difference over the CPU's norm
    (``tol['step']``): the card sums in another order, and at 4-bit
    activations a code may flip on that.
    The step's Adam update, lr * g / (|g| + eps), moves no more than the
    gradient does, relatively. Each group moves at least a quarter of its
    learning rate somewhere, so a step that changed nothing fails."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    moved = {}
    for dev in (torch.device("cpu"), cuda):
        _, start = _calib_one_step(dev, let, abits, group_size, epochs=0)
        (loss,), end = _calib_one_step(dev, let, abits, group_size)
        assert math.isfinite(loss)
        moved[dev.type] = loss, {
            g: torch.cat([(b - a).reshape(-1) for a, b in zip(start[g], v)])
            for g, v in end.items()}
    (l_cpu, d_cpu), (l_gpu, d_gpu) = moved["cpu"], moved["cuda"]
    assert abs(l_gpu - l_cpu) <= tol["loss"] * abs(l_cpu)
    assert sorted(d_gpu) == sorted(d_cpu) == (["let", "lwc"] if let
                                              else ["lwc"])
    for g, lr in (("let", 5e-3), ("lwc", 1e-2)):
        if g in d_cpu:
            assert d_cpu[g].abs().max() >= lr / 4, g
            assert ((d_gpu[g] - d_cpu[g]).norm()
                    <= tol["step"] * d_cpu[g].norm()), g


def _tiny_opt(dev, kv_dtype, widths=(256, 512, 2), **kw):
    """A 2-layer OPT (hidden, ffn and heads ``widths``: by default 256,
    512 and 2 heads of 128) with random biases, packed W4 g128 (pairs) on
    the CPU, as a bf16 OPTEngine on ``dev``."""
    from omniquant_tpu_torch.models import OPT, opt
    from omniquant_tpu_torch.serving import OPTEngine

    hidden, ffn, heads = widths
    cfg = opt.OPTConfig(vocab_size=256, hidden_size=hidden, ffn_dim=ffn,
                        num_hidden_layers=2, num_attention_heads=heads,
                        max_position_embeddings=512)
    gen = torch.Generator().manual_seed(7)
    dense = opt.init_params(gen, cfg, device="cpu")
    for b in dense["layers"]:
        for sub in b.values():
            sub["bias"].normal_(0.0, 0.02, generator=gen)
    packed = pack_model(OPT, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    return OPTEngine(packed, cfg, dtype=torch.bfloat16, kv_dtype=kv_dtype,
                     device=dev, **kw)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_opt_engine_on_the_card_matches_cpu(cuda, kv_dtype):
    """The OPT engine on the card (K1 at prefill and decode, K2 on the
    40-token prompt's 64-row bucket, K3, K4; int8: K6 too) against the
    same engine on the CPU (every plain version): prefill and first decode
    logits. Both round bf16 activations, in other orders, so the bound is
    on the rms error (2e-2 of the logits' rms)."""
    from omniquant_tpu_torch import kernels

    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = _tiny_opt(dev, kv_dtype, max_batch=4, max_len=128,
                        flash_min_len=32)
        kernels.reset_launch_counts()
        slots, lg = eng.add_requests(reqs, return_logits=True)
        toks, lens = eng._device_tokens({s: 1 for s in slots})
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))[:len(slots)]
        logits.append(torch.cat([lg.float().cpu(), dec.float().cpu()]))
        counts = kernels.launch_counts()
    path = ["quant_matmul", "quant_matmul_prefill", "flash_attention",
            "kv_cache_prefill_write", "kv_cache_write"]
    if kv_dtype == "int8":
        path.append("decode_attention_int8")
    assert all(counts[k] > 0 for k in path), counts
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 2e-2


def test_opt_decode_does_not_synchronize(cuda):
    """The int8 OPT engine's decode step, step_n (ring) and verify pass:
    the learned positions are indexed on the device, so no host
    synchronisation inside the layer loop."""
    eng = _tiny_opt(cuda, "int8", max_batch=4, max_len=128)
    slots = eng.add_requests([[1, 2, 3, 4, 5], [6, 7, 8]])
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    verify = torch.full((4, 3), 5, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_impl(toks, lens, 64)
        eng._decode_multi_impl(toks, lens + 1, 64, 4, False)
        eng._verify_impl(verify, lens + 5, 64, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# OPT at head_dim 80 (OPT-2.7B's): hidden 640 in 8 heads, ffn 2560, so
# every linear has N % 128 == 0 and reaches K1, as at 2.7B's widths
_OPT_HD80 = (640, 2560, 8)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_opt_hd80_engine_on_the_card_matches_cpu(cuda, kv_dtype):
    """An OPT engine with heads of 80 on the card (K1 on every linear, K2 on
    the 40-token prompt's 64-row bucket at hd 80, K3, K4; int8: K6 at hd
    80, and step_n's ring with K5) against the same engine on the CPU:
    prefill and first decode logits within 2e-2 of the logits' rms, as
    test_opt_engine_on_the_card_matches_cpu."""
    from omniquant_tpu_torch import kernels

    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = _tiny_opt(dev, kv_dtype, _OPT_HD80, max_batch=4, max_len=128,
                        flash_min_len=32)
        assert eng.cfg.head_dim == 80
        kernels.reset_launch_counts()
        slots, lg = eng.add_requests(reqs, return_logits=True)
        toks, lens = eng._device_tokens({s: 1 for s in slots})
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))[:len(slots)]
        logits.append(torch.cat([lg.float().cpu(), dec.float().cpu()]))
        out = eng.step_n({s: 2 for s in slots}, 4)
        assert all(0 <= t < 256 for ts in out.values() for t in ts)
        counts = kernels.launch_counts()
    path = ["quant_matmul", "quant_matmul_prefill", "flash_attention",
            "kv_cache_prefill_write", "kv_cache_write"]
    if kv_dtype == "int8":
        path += ["decode_attention_int8", "kv_cache_write_span"]
    assert all(counts[k] > 0 for k in path), counts
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 2e-2


def test_opt_hd80_launches_k2_and_k6_without_synchronizing(cuda):
    """At head_dim 80 the int8 OPT engine's flash prefill (K2), decode
    step (K6), step_n (K6 with the ring) and verify pass queue their work
    with no host synchronisation, and K2 and K6 launch."""
    eng = _tiny_opt(cuda, "int8", _OPT_HD80, max_batch=4, max_len=128,
                    flash_min_len=32)
    tokens = torch.tensor([[(3 * i + j) % 256 for i in range(64)]
                           for j in range(2)], dtype=torch.int32,
                          device=cuda)
    slots = eng.add_requests([[1, 2, 3, 4, 5], [6, 7, 8]])
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    verify = torch.full((4, 3), 5, dtype=torch.int32, device=cuda)
    prefill_slots = torch.tensor([2, 3], dtype=torch.int32, device=cuda)
    last_idx = torch.tensor([63, 63], dtype=torch.int32, device=cuda)
    eng._ensure_prefill_capacity(64)
    k2, k6 = flash_attention.launches, decode_attention_int8.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._prefill_multi_impl(tokens, prefill_slots, last_idx, 64)
        eng._decode_impl(toks, lens, 64)
        eng._decode_multi_impl(toks, lens + 1, 64, 4, False)
        eng._verify_impl(verify, lens + 5, 64, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert flash_attention.launches > k2
    assert decode_attention_int8.launches > k6


# Falcon forms at hd 64 whose int8 decode runs K6 with head groups: 16
# query heads on one kv head (multi-query), 16 on 2 (the new decoder
# architecture), and 16 heads with ALiBi (K2's ALiBi path at prefill, no
# fused decode attention)
_FALCON_FORMS = {
    "mqa": dict(),
    "gqa": dict(new_decoder_architecture=True, num_kv_heads=2),
    "alibi": dict(multi_query=False, parallel_attn=False, alibi=True,
                  bias=True),
}


def _tiny_falcon(dev, form, kv_dtype, **kw):
    """A 2-layer Falcon (hidden 1024, 16 heads of 64) of ``form``, packed
    W4 g128 (pairs) on the CPU, as a bf16 FalconEngine on ``dev``."""
    from omniquant_tpu_torch.models import FALCON, falcon
    from omniquant_tpu_torch.serving import FalconEngine

    cfg = falcon.FalconConfig(vocab_size=256, hidden_size=1024,
                              num_hidden_layers=2, num_attention_heads=16,
                              **_FALCON_FORMS[form])
    gen = torch.Generator().manual_seed(9)
    dense = falcon.init_params(gen, cfg, device="cpu")
    for b in dense["layers"]:
        for sub in b.values():
            if sub.get("bias") is not None:
                sub["bias"].normal_(0.0, 0.02, generator=gen)
    packed = pack_model(FALCON, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    return FalconEngine(packed, cfg, dtype=torch.bfloat16, kv_dtype=kv_dtype,
                        device=dev, **kw)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("form", list(_FALCON_FORMS))
def test_falcon_engine_on_the_card_matches_cpu(cuda, form, kv_dtype):
    """The Falcon engine on the card (K1, K2 on the 40-token prompt's
    64-row bucket, with the slopes under ALiBi, K3, K4; int8 without ALiBi:
    K6 with its head groups, then step_n through the ring and K5) against
    the same engine on the CPU: prefill and first decode logits at the
    OPT engine test's rms bound, and the step_n streams' shape."""
    from omniquant_tpu_torch import kernels

    reqs = [[(7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12))]
    logits = []
    for dev in ("cpu", "cuda"):
        eng = _tiny_falcon(dev, form, kv_dtype, max_batch=4, max_len=128,
                           flash_min_len=32)
        kernels.reset_launch_counts()
        slots, lg = eng.add_requests(reqs, return_logits=True)
        toks, lens = eng._device_tokens({s: 1 for s in slots})
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))[:len(slots)]
        logits.append(torch.cat([lg.float().cpu(), dec.float().cpu()]))
        streams = eng.step_n({s: 1 for s in slots}, 4)
        counts = kernels.launch_counts()
        assert all(len(v) == 4 for v in streams.values())
    path = ["quant_matmul", "quant_matmul_prefill", "flash_attention",
            "kv_cache_prefill_write", "kv_cache_write"]
    if kv_dtype == "int8" and form != "alibi":
        path += ["decode_attention_int8", "kv_cache_write_span"]
    assert all(counts[k] > 0 for k in path), counts
    if form == "alibi":
        assert counts["decode_attention_int8"] == 0
    d = logits[1] - logits[0]
    assert (d.pow(2).mean().sqrt() / logits[0].pow(2).mean().sqrt()) < 2e-2


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("form", ["mqa", "alibi"])
def test_falcon_decode_does_not_synchronize(cuda, form, kv_dtype):
    """The Falcon engine's decode step, step_n (the ring for int8 without
    ALiBi) and verify pass run with no host synchronisation: multi-query,
    and ALiBi, whose bias must not be copied from the host each layer."""
    eng = _tiny_falcon(cuda, form, kv_dtype, max_batch=4, max_len=128)
    slots = eng.add_requests([[1, 2, 3, 4, 5], [6, 7, 8]])
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    verify = torch.full((4, 3), 5, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_impl(toks, lens, 64)
        eng._decode_multi_impl(toks, lens + 1, 64, 4, False)
        eng._verify_impl(verify, lens + 5, 64, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("net", ["tiny-opt", "tiny-llama", "tiny-falcon"])
def test_cli_on_the_card(cuda, tmp_path, net):
    """``python -m omniquant_tpu_torch`` on its default platform, the card:
    calibrate, perplexity, pack and serve; the results JSON last, and K1,
    K3 and K4 launched by the packed model's engine."""
    import json
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-m", "omniquant_tpu_torch", "--synthetic", "--net",
         net, "--wbits", "4", "--abits", "16", "--group_size", "64", "--lwc",
         "--epochs", "1", "--nsamples", "4", "--seqlen", "128", "--eval_ppl",
         "--real_quant", "--serve_prompt", "hello there",
         "--max_new_tokens", "8", "--save_dir", str(tmp_path / "save"),
         "--output_dir", str(tmp_path / "out"), "--cache_dir",
         str(tmp_path / "cache")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert math.isfinite(last["synthetic"]) and len(last["generation"]) == 8
    counts = json.loads(re.search(r"kernel launches: (\{.*\})",
                                  out.stdout).group(1))
    for k in ("quant_matmul", "kv_cache_prefill_write", "kv_cache_write"):
        assert counts[k] > 0, counts
    assert (tmp_path / "save" / "model_packed.npz").exists()


# ---------------------------------------------------------------------------
# speculative decoding and auto_grow: the shapes their paths reach first


@pytest.mark.parametrize("m", [5, 8, 40])
@pytest.mark.parametrize("in_f,out_f", [
    (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
    (4096, 32000)])
def test_quant_matmul_at_spec_shapes(cuda, in_f, out_f, m):
    """K1 (W4 g128 pairs) at the LLaMA-7B products of a spec round: the
    draft's decode steps (m = 8, and 5, a verify of gamma + 1 = 5 tokens on
    one slot) on the decode tile, the verify pass of 8 slots x 5 tokens (m
    = 40) on the prefill tile, and N = 32000, a draft head packed at 4 bits
    (draft_head_bits), each against its plain version."""
    pw = _packed(cuda, 4, 128, out_f, in_f, seed=m + out_f)
    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, in_f, generator=gen, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches, quant_matmul.launches_prefill
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert (quant_matmul.launches, quant_matmul.launches_prefill) == (
        before[0] + 1, before[1] + (m > 32))
    ok, err, worst = tolerance.bf16_close(got, quant_matmul_reference(x, pw),
                                          tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("in_f,out_f", [(4096, 12288), (11008, 4096),
                                        (4096, 22016)])
def test_quant_matmul_int_at_verify_shape(cuda, in_f, out_f, m):
    """K7 (W6 g128 planar, 6-bit activations) at a W6A6 spec round's shapes:
    the draft's steps (m = 8) and the verify pass of 8 x 5 tokens (m = 40),
    one launch each, against the plain version."""
    pw = _int_packed(cuda, 6, 128, out_f, in_f, "planar", seed=m + in_f)
    cfg = QuantConfig(n_bits=6)
    x = torch.randn(m, in_f, device=cuda).to(torch.bfloat16)
    before = qmm.quant_matmul_int.launches
    got = qmm.quant_matmul_int(x, pw, cfg)
    torch.cuda.synchronize()
    assert qmm.quant_matmul_int.launches == before + 1
    _int_check(got, x, pw, cfg)


def _tiny_spec_engine(dev, kv_dtype, **kw):
    from omniquant_tpu_torch.models import LLAMA

    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=3,
                            num_attention_heads=2, num_key_value_heads=2)
    dense = llama.init_params(torch.Generator().manual_seed(4), cfg,
                              device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    return LlamaEngine(packed, cfg, max_batch=4, dtype=torch.bfloat16,
                       kv_dtype=kv_dtype, device=dev, **kw)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_spec_rounds_do_not_synchronize(cuda, kv_dtype):
    """SpecDecoder's fused rounds (the draft's decode steps and argmaxes,
    the verify pass, the accepted counts, the next lengths) queue their
    work without a host synchronisation; the layer-skip draft adds only its
    KV cache to the memory allocated."""
    from omniquant_tpu_torch.serving import SpecDecoder

    eng = _tiny_spec_engine(cuda, kv_dtype, max_len=128)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sd = SpecDecoder(eng, draft_layers=1, gamma=3)
    torch.cuda.synchronize()
    cache = sum(t.numel() * t.element_size()
                for bufs in (sd.draft.cache.k, sd.draft.cache.v,
                             sd.draft.cache.k_scale, sd.draft.cache.v_scale)
                if bufs for t in bufs)
    assert torch.cuda.memory_allocated() - before == cache
    slots = [sd.add_request(p) for p in ([1, 2, 3, 4, 5], [6, 7, 8])]
    sd.spec_steps({s: 9 for s in slots}, rounds=1)  # builds the libraries
    toks, lens = eng._device_tokens({s: 9 for s in slots})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, n_emit = sd._rounds(toks, lens, 2, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert outs.shape == (2, 4, 4) and n_emit.shape == (2, 4)
    assert bool(((n_emit >= 1) & (n_emit <= 4)).all())


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_grown_cache_on_the_card_keeps_its_rows(cuda, kv_dtype):
    """auto_grow on the card: the grown buffers hold the old rows bit for
    bit (codes and scale planes for int8) and zeros past them, and a decode
    step after the growth (K4, and K6 over the grown int8 window) gives the
    logits of an engine built at the grown length holding the same
    cache."""
    eng = _tiny_spec_engine(cuda, kv_dtype, max_len=64, auto_grow=True)
    slots = eng.add_requests([list(range(1, 41)), list(range(7, 30))])
    eng.step_n({s: 3 for s in slots}, 8)
    c = eng.cache
    old = [t.clone() for bufs in (c.k, c.v, c.k_scale, c.v_scale) if bufs
           for t in bufs]
    eng._check_capacity(slots, 30)
    assert eng.max_len == 128
    c = eng.cache
    new = [t for bufs in (c.k, c.v, c.k_scale, c.v_scale) if bufs
           for t in bufs]
    for o, n in zip(old, new):
        assert torch.equal(n[:, :, :64], o) and not n[:, :, 64:].any()
    big = _tiny_spec_engine(cuda, kv_dtype, max_len=128)
    big.lengths[:], big.active[:] = eng.lengths, eng.active
    for dst, src in zip([t for bufs in (big.cache.k, big.cache.v,
                                        big.cache.k_scale, big.cache.v_scale)
                         if bufs for t in bufs], new):
        dst.copy_(src)
    toks, lens = eng._device_tokens({s: 5 for s in slots})
    got = eng._decode_impl(toks, lens, eng._kv_len(1))
    want = big._decode_impl(toks, lens, big._kv_len(1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _tiny_opt_packed(widths=_OPT_HD80):
    """(cfg, pack): _tiny_opt's model, packed W4 g128 on the CPU."""
    from omniquant_tpu_torch.models import OPT, opt

    hidden, ffn, heads = widths
    cfg = opt.OPTConfig(vocab_size=256, hidden_size=hidden, ffn_dim=ffn,
                        num_hidden_layers=2, num_attention_heads=heads,
                        max_position_embeddings=512)
    gen = torch.Generator().manual_seed(7)
    dense = opt.init_params(gen, cfg, device="cpu")
    for b in dense["layers"]:
        for sub in b.values():
            sub["bias"].normal_(0.0, 0.02, generator=gen)
    return cfg, pack_model(OPT, dense, QuantConfig(n_bits=4, group_size=128),
                           device="cpu")


def _harness_requests(seed=3):
    """Loglikelihood requests (contexts of 5 to 300 characters), a rolling
    doc longer than the 512-token window, and greedy_until contexts of
    which one is 300 characters (K2 at the engine's prefill)."""
    import random

    rnd = random.Random(seed)

    def text(n):
        return "".join(rnd.choice("abcdefghij klmnop.") for _ in range(n))

    ll = [(text(n), " " + text(rnd.randint(1, 12)))
          for n in (5, 17, 40, 90, 120, 300, 8, 64, 33)] + [("", "xyz")]
    return ll, [(text(1200),)], [(text(n), ["\n"]) for n in (300, 20, 70)]


def test_torchlm_on_the_card_matches_cpu(cuda):
    """TorchLM on the card (bf16: K1 on the scoring chunks' prefill tile
    and the decode tile, K2 on a 300-token prompt, K3, K4) against TorchLM
    on the CPU (every plain version) on a tiny packed OPT at head_dim 80:
    each loglikelihood and the rolling sum within the e2e bound applied per
    token (chip_smoke.harness_hold's: twice E2E_TOL's max times each row's
    largest |logit| in the plain f32 forward), each token's greedy flag
    (the card's chunks re-scored) equal to the plain forward's but where
    that token is a near tie, and the card's greedy texts held by the
    near-tie rule."""
    import chip_smoke as cs
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.cli import CharTokenizer
    from omniquant_tpu_torch.eval.harness import TorchLM
    from omniquant_tpu_torch.models import OPT
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT

    cfg, packed = _tiny_opt_packed()
    ll, rolling, gen = _harness_requests()
    out = {}
    for dev in ("cpu", "cuda"):
        lm = TorchLM(OPT, packed, cfg, CharTokenizer(256), seqlen=512,
                     batch_size=4, max_gen_toks=12, device=dev,
                     dtype=torch.bfloat16)
        kernels.reset_launch_counts()
        out[dev] = (lm.loglikelihood(ll), lm.loglikelihood_rolling(rolling),
                    lm.greedy_until(gen), kernels.launch_counts())
    counts = out["cuda"][3]
    for k in ("quant_matmul_prefill", "flash_attention",
              "kv_cache_prefill_write", "kv_cache_write"):
        assert counts[k] > 0, (k, counts)
    assert counts["quant_matmul"] > counts["quant_matmul_prefill"], counts
    ref = cs.plain_reference_params(torch, packed)
    pairs = [([0] if c == "" else lm.tok_encode(c), lm.tok_encode(x))
             for c, x in ll]
    want = cs._token_stats(torch, OPT, cfg, ref, NO_ACT_QUANT, pairs, 512, 4,
                           "cpu", rows=True)
    # the card's per-token flags: its chunks re-scored (the same sums)
    got = cs._token_stats(torch, OPT, cfg, lm.params, NO_ACT_QUANT, pairs,
                          512, 4, lm.device)
    tol = cs.E2E_TOL["max"]
    for (g, gf), (c, cf), w, t in zip(out["cuda"][0], out["cpu"][0], want,
                                      got):
        bound = 2 * tol * w["mag"].sum().item()
        assert abs(g - c) <= bound and abs(g - w["lp"].sum().item()) <= bound
        assert abs(t["lp"].sum().item() - g) <= 1e-3
        assert gf == bool(t["greedy"].all())
        # every token whose argmax flipped is itself a near tie
        flips = t["greedy"] != w["greedy"]
        if flips.any():
            assert (w["top_gap"][flips] / w["mag"][flips]).max() <= (
                cs.SPEC_TIE * tol)
    from omniquant_tpu_torch.eval.harness import (
        get_rolling_token_windows, make_disjoint_window)

    windows = [make_disjoint_window(w) for w in get_rolling_token_windows(
        lm.tok_encode(rolling[0][0]), 0, 512, 1)]
    assert len(windows) == 3
    bound = sum(2 * tol * w["mag"].sum().item() for w in cs._token_stats(
        torch, OPT, cfg, ref, NO_ACT_QUANT, windows, 512, 4, "cpu",
        rows=True))
    assert abs(out["cuda"][1][0] - out["cpu"][1][0]) <= bound
    gaps = cs.text_stream_gaps(torch, OPT, cfg, ref, NO_ACT_QUANT, lm, gen,
                               out["cuda"][2], "cpu")
    assert gaps and cs.near_tie(gaps, cs.SPEC_TIE * tol)["ok"]


# ---------------------------------------------------------------------------
# multi-process serving: two gloo ranks on the one card

_MP_RANK = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[4])
from omniquant_tpu_torch.models import LLAMA, llama
from omniquant_tpu_torch.parallel import (
    MultihostConfig, init_multihost, make_mesh)
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.serving import (
    DPServingCoordinator, LlamaEngine, pack_model)

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dev = init_multihost(MultihostConfig(f"localhost:{port}", 2, rank,
                                     timeout_s=120), "cuda")
mesh = make_mesh(tp=2)
res = {"backend": torch.distributed.get_backend(), "local": mesh.local}
for dtype in (torch.bfloat16, torch.float32):
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    x = torch.randn(64, 4096, generator=gen, device=dev).to(dtype)
    got = mesh.run(lambda p, x: mesh.all_reduce(p, x),
                   mesh.each(lambda p, d: x))
    res[str(dtype)] = mesh.first(got).cpu()
cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=2)
dense = llama.init_params(torch.Generator().manual_seed(1), cfg,
                          device="cpu")
packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                    device="cpu")
eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                  dtype=torch.bfloat16, device=dev)
reqs = [[(5 * i + j) % 256 for i in range(n)]
        for j, n in enumerate((40, 33, 12, 20))]
res["streams"] = DPServingCoordinator(eng).generate_all(
    reqs, max_new_tokens=12, step=4)
torch.save(res, out)
torch.distributed.destroy_process_group()
"""


def _two_ranks_on_the_card(tmp_path):
    """Both ranks of _MP_RANK, each with a timeout; their results."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MP_RANK, str(r), str(port),
         str(tmp_path / f"rank{r}.pt"), repo], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _two_ranks_on_the_card(tmp_path_factory.mktemp("mp"))


def test_all_reduce_across_processes_on_the_card(cuda, two_ranks):
    """Two ranks, one shard each on the card (gloo: the partials travel
    through the host): each rank's sum of CUDA partials, bf16 and f32, is
    the in-process fold's bit for bit."""
    from omniquant_tpu_torch.parallel import Mesh

    for r, res in enumerate(two_ranks):
        assert res["local"] == [r]
        assert res["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                                  else "gloo")
    for dtype in (torch.bfloat16, torch.float32):
        parts = [torch.randn(64, 4096, generator=torch.Generator(
            device=cuda).manual_seed(100 + r), device=cuda).to(dtype)
            for r in range(2)]
        want = Mesh([cuda] * 2)._reduce(parts, "sum")[0].cpu()
        for res in two_ranks:
            got = res[str(dtype)]
            assert got.dtype == dtype and torch.equal(got, want)


def test_dp_generate_all_on_the_card(cuda, two_ranks):
    """DPServingCoordinator over the two ranks (two requests each, routed
    round-robin): both gather the same global streams, which are those of
    one process's engine of the same capacity serving each rank's two."""
    from omniquant_tpu_torch.serving import DPServingCoordinator

    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2)
    dense = llama.init_params(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device="cpu")
    reqs = [[(5 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((40, 33, 12, 20))]
    want = [None] * 4
    for r in range(2):
        eng = LlamaEngine(packed, cfg, max_batch=4, max_len=128,
                          dtype=torch.bfloat16, device=cuda)
        want[r::2] = DPServingCoordinator(eng).generate_all(
            reqs[r::2], max_new_tokens=12, step=4)
    assert two_ranks[0]["streams"] == two_ranks[1]["streams"] == want
