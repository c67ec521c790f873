"""Plain PyTorch version of the output-stationary GEMM:
``C = act(A @ B + bias)``, computed in float32.

``split_tf32`` and ``matmul_tf32x3`` emulate, in plain float32, the
arithmetic of the float32 ``tf32x3`` routes (``csrc/hopper.cuh``:
split_tf32): the tests hold that arithmetic to float64 on the CPU, where
no kernel runs.  No wrapper calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ACTIVATIONS = (None, "relu", "gelu", "silu")


def gemm_ref(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             out_dtype=None) -> torch.Tensor:
    """a: (M, K), b: (K, N), bias: (N,) or None; activation one of
    ACTIVATIONS (gelu in its tanh form).  Returns (M, N) in ``out_dtype``
    (default a's)."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()[None, :]
    if activation == "relu":
        acc = torch.clamp_min(acc, 0.0)
    elif activation == "gelu":
        acc = 0.5 * acc * (1.0 + torch.tanh(
            0.7978845608028654 * (acc + 0.044715 * acc ** 3)))
    elif activation == "silu":
        acc = acc * (1.0 / (1.0 + torch.exp(-acc)))
    elif activation is not None:
        raise ValueError(activation)
    return acc.to(out_dtype)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``: half an ulp of TF32
    added to the magnitude's bits, the low 13 bits cleared.  Infinities
    and NaNs are kept."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` as hi + lo, each a TF32 number: hi = tf32(x), lo =
    tf32(x - hi) (x - hi is exact in float32), so hi + lo = x to 2^-22
    relative; lo = 0 where hi is not finite."""
    x = x.float()
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(lo))


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor,
                  chunk: int = 8) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the tf32x3 routes take it: each operand split
    by ``split_tf32``, and per ``chunk`` of k (one m16n8k8 step) the
    products a_lo b_hi, a_hi b_lo and a_hi b_hi added to a float32 sum in
    that order (a_lo b_lo dropped).  Each chunk's products of TF32 numbers
    are exact in float32; only the sums round."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], chunk):
        k = slice(k0, k0 + chunk)
        acc = acc + a_lo[:, k] @ b_hi[k]
        acc = acc + a_hi[:, k] @ b_lo[k]
        acc = acc + a_hi[:, k] @ b_hi[k]
    return acc
