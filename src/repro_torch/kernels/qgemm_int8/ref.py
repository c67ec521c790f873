"""Plain PyTorch version of the int8 quantized GEMM (the edge-inference
datapath), and the quantization helpers that go with it."""
from __future__ import annotations

import torch


def int_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 a (M, K) and b (K, N), wrapping modulo
    2^32 as the reference's int32 accumulator does once K * 128^2 passes
    2^31 - 1.

    PyTorch multiplies int32 matrices on the CPU but not on CUDA, so the
    product is taken in float64: every partial sum is an integer of at
    most K * 128^2, exact while that stays below 2^53.  The exact sum goes
    through int64 to int32, which keeps its low 32 bits."""
    return torch.matmul(a.double(), b.double()).to(torch.int64) \
        .to(torch.int32)


def qgemm_ref(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
              b_scale: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """C = (a_scale[:, None] * b_scale[None, :]) * (int8 A @ int8 B).

    a: (M, K) int8, b: (K, N) int8, a_scale: (M,) float32 per row,
    b_scale: (N,) float32 per column.  The int32 accumulator goes to
    float32 and is scaled by the row's scale, then by the column's."""
    acc = int_matmul_ref(a, b)
    out = acc.float() * a_scale[:, None] * b_scale[None, :]
    return out.to(out_dtype)


def requantize_ref(acc, mult: int, shift: int, qmin: int = -127,
                   qmax: int = 127):
    """Fixed-point requantization: ``clamp((acc * mult) >> shift)``.

    Operators only, so it runs alike on numpy arrays and torch integer
    tensors; it is the golden model of the CGRA-side ``requant-int8``
    kernel, which pins the fabric datapath and the int8 GEMM path to one
    rounding and saturation rule."""
    v = (acc * mult) >> shift
    return v.clip(qmin, qmax)


def quantize_rowwise(x: torch.Tensor):
    """Symmetric per-row int8 quantization: returns (q, scale).  Rounds
    half to even."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale
