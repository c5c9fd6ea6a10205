"""Packed-weight matmul: y = x @ dequant(W) (+ bias), W4A16 and kin.

Counterpart of ``omniquant_tpu/kernels/quant_matmul.py::quant_matmul`` with
the same host routing:

* N % 128 != 0 goes to the dense reference;
* m >= 4096 with a column block below 1024 (e.g. fused gate+up at
  N = 22016) dequantizes the weight once and calls ``torch.matmul``, as the
  JAX package hands that case to XLA;
* everything else runs the fused kernel: on a CUDA tensor the hand-written
  ``csrc/quant_matmul.cu`` (pairs layout, bits 2/3/4, bf16 activations,
  scales and zeros), on
  a CPU tensor its plain version ``quant_matmul_reference``.

Geometry comes from the tensor shapes (qweight's column count is N), as in
the JAX package. x's last dim is the logical in_features; rows past it up to
the packed length count as zeros.
"""
from __future__ import annotations

import math

import torch

from ..quant.packing import PackedWeight, dequantize_packed
from . import _build

_CUDA_GROUP_MULTIPLE = 64  # deepest K step of the CUDA kernel's tile shapes
# column blocks of the JAX kernel, widest first: N's widest divisor among
# them decides the dequantize-once route at m >= 4096, as it does there
_BLOCK_N = (2048, 1024, 512, 256, 128)


def quant_matmul_reference(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Plain version: dequantize in f32, f32 product, cast to x.dtype, then
    add the bias in x.dtype."""
    w = dequantize_packed(pw, dtype=torch.float32)  # (in, out)
    pad = w.shape[0] - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    y = torch.matmul(x.float(), w).to(x.dtype)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y


def _qmm_cuda(x2: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Launch the CUDA kernel on x2 (m, K) bf16; no bias."""
    if pw.layout != "pairs" or pw.bits not in (2, 3, 4):
        raise NotImplementedError(
            f"the CUDA quant_matmul takes the pairs layout at 2/3/4 bits; "
            f"got {pw.layout} at {pw.bits} bits")
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA quant_matmul takes bf16 x, not {x2.dtype}")
    if pw.group_size and pw.group_size % _CUDA_GROUP_MULTIPLE:
        raise NotImplementedError(
            f"group_size {pw.group_size} is not a multiple of "
            f"{_CUDA_GROUP_MULTIPLE}")
    if not pw.scales.dtype == pw.zeros.dtype == torch.bfloat16:
        raise NotImplementedError(
            "the CUDA quant_matmul takes bf16 scales and zeros (a bf16 engine "
            f"rounds them so); got {pw.scales.dtype} and {pw.zeros.dtype}")
    qweight = pw.qweight
    if not (qweight.is_cuda and qweight.dtype == torch.int32
            and qweight.is_contiguous()):
        raise ValueError("qweight must be a contiguous int32 CUDA tensor")
    x2 = x2.contiguous()
    m, K = x2.shape
    k_pad = pw.k_pad
    N = qweight.shape[1]
    G = pw.scales.shape[1]
    if K > k_pad or pw.scales.shape[0] != N or pw.zeros.shape != pw.scales.shape:
        raise ValueError("x, qweight and scales disagree on the geometry")
    scales, zeros = pw.scales.contiguous(), pw.zeros.contiguous()
    y = torch.empty((m, N), dtype=x2.dtype, device=x2.device)
    x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
    _build.launch(
        "quant_matmul", "qmm_pairs_bf16", "pppppiiiiiiiii",
        x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        zeros.data_ptr(), y.data_ptr(), m, K, N, k_pad, G,
        pw.group_size or k_pad, pw.tile_k, pw.bits, x_vec)
    quant_matmul.launches += 1
    return y


def quant_matmul(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y = x @ dequant(pw) (+ bias). x: (..., in_features_logical)."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    n = pw.qweight.shape[1]
    if n % 128 != 0:
        return quant_matmul_reference(x, pw).reshape(*lead, n)
    bn = next(b for b in _BLOCK_N if n % b == 0)
    x2 = x.reshape(m, x.shape[-1])
    if m >= 4096 and bn < 1024:
        w = dequantize_packed(pw, dtype=x.dtype)
        pad = w.shape[0] - x2.shape[-1]
        if pad:
            x2 = torch.nn.functional.pad(x2, (0, pad))
        y = x2 @ w
    elif not x2.is_cuda:
        return quant_matmul_reference(x, pw).reshape(*lead, n)
    else:
        y = _qmm_cuda(x2, pw)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y.reshape(*lead, n)


quant_matmul.launches = 0
