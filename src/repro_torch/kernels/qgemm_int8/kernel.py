"""Launcher of the hand-written Hopper int8 GEMM (``csrc/qgemm_int8.cu``),
bound with ctypes.

A block owns a 128 x 128 tile of C and keeps its int32 accumulator in
registers while K streams through in steps of 32, four k to a ``__dp4a``;
the scales are applied once at the end in the plain version's order, so
the two agree bit for bit.  Ragged M, N and K are masked in the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..common import check_on_card

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The largest K whose int32 sums cannot wrap: |a * b| <= 128^2 for int8,
# and K * 128^2 must stay at or below 2^31 - 1.
K_MAX = (2 ** 31 - 1) // 128 ** 2


def check_k(K: int) -> None:
    if K > K_MAX:
        raise ValueError(f"K={K} could wrap the int32 accumulator; "
                         f"qgemm_int8 takes K <= {K_MAX}")


@functools.cache
def _entry():
    fn = _build.load("qgemm_int8").repro_qgemm_int8
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def qgemm_int8_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                    b_scale: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a: (M, K), b: (K, N) int8; a_scale: (M,), b_scale: (N,) float32;
    all contiguous on one CUDA device.  Returns (M, N) in ``out_dtype``
    (float32 or bfloat16)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"qgemm_int8 kernel takes int8 a/b, got {a.dtype}, "
                        f"{b.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError(f"qgemm_int8 kernel takes float32 scales, got "
                        f"{a_scale.dtype}, {b_scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qgemm_int8 kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a_scale.shape != (a.shape[0],) or b_scale.shape != (b.shape[1],):
        raise ValueError(
            f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, a_scale "
            f"{tuple(a_scale.shape)}, b_scale {tuple(b_scale.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, K, N) == 0:
        raise ValueError(f"empty product: M={M}, K={K}, N={N}")
    check_k(K)
    check_on_card([("a", a), ("b", b), ("a_scale", a_scale),
                   ("b_scale", b_scale)])
    if a.data_ptr() % 4:     # the kernel reads a's rows in 4-byte words
        raise ValueError("a must be 4-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry()(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                       b_scale.data_ptr(), out.data_ptr(), M, N, K,
                       _OUT_DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"qgemm_int8 kernel launch failed: CUDA error "
                           f"{err}")
    return out
