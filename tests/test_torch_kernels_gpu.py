"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card. These need a CUDA card and nvcc; without a card they skip. On the
machine with the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not have; nothing here imports JAX.)

Tolerances: the products (quant_matmul, flash_attention) round an f32 sum
to bf16 once in both versions, so each element may differ by 2 bf16 ulps of
its own size plus the kernel's slack (``kernels/tolerance.py``); the cache
writes are copies and must be exact.
"""
import pytest
import torch

from omniquant_tpu_torch.kernels import kv_update, tolerance
from omniquant_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from omniquant_tpu_torch.kernels.quant_matmul import (
    quant_matmul, quant_matmul_reference)
from omniquant_tpu_torch.models import LLAMA, llama
from omniquant_tpu_torch.quant import QuantConfig, pack_weight
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


@pytest.mark.parametrize("m", [1, 7, 32, 33, 300])
@pytest.mark.parametrize("bits,group_size,in_f", [
    (4, 128, 1024), (4, 128, 640), (3, 128, 1280), (2, 128, 1024),
    (4, None, 1024), (3, None, 640), (2, 256, 1024)])
def test_quant_matmul_kernel(cuda, bits, group_size, in_f, m):
    pw = _packed(cuda, bits, group_size, 384, in_f, seed=bits + m,
                 bias=m == 7)
    x = torch.randn(m, in_f, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches
    got = quant_matmul(x, pw)
    want = quant_matmul_reference(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, 384)
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.QUANT_MATMUL_SLACK)
    assert ok, (err, worst)


def test_quant_matmul_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(256, 512, generator=gen, device=cuda)
    planar = pack_weight(w, QuantConfig(n_bits=4, group_size=128),
                         layout="planar")
    x = torch.randn(4, 512, device=cuda).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        quant_matmul(x, planar)
    pairs = pack_weight(w, QuantConfig(n_bits=4, group_size=128),
                        layout="pairs")
    with pytest.raises(ValueError):
        quant_matmul(x.float(), pairs)
    with pytest.raises(NotImplementedError):  # f32 scales: a bf16 engine
        quant_matmul(x, pairs)                # serves bf16 ones


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,alibi", [
    (2, 4, 4, 256, 128, True, False),
    (1, 8, 2, 200, 128, True, False),   # GQA, ragged
    (1, 4, 1, 96, 64, True, True),      # MQA, ALiBi, head_dim 64
    (2, 2, 2, 130, 128, False, False),  # not causal, ragged
    (1, 4, 4, 1, 128, True, False),     # a single query
])
def test_flash_attention_kernel(cuda, B, H, Hkv, S, D, causal, alibi):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, H, S, D, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=cuda).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=gen, device=cuda).to(
        torch.bfloat16)
    slopes = (2.0 ** (-8.0 * torch.arange(1, H + 1, device=cuda) / H)
              if alibi else None)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, alibi_slopes=slopes)
    want = flash_attention_plain(q, k, v, causal=causal, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ok, err, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(
            q, k, v, causal=causal, alibi_slopes=slopes))
    assert ok, (err, worst)


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
