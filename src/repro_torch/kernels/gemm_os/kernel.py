"""Launcher of the hand-written Hopper output-stationary GEMM
(``csrc/gemm_os.cu``), bound with ctypes.

A block owns a 128 x 128 tile of C and keeps it in registers while K
streams through in steps of 8; the kernel masks ragged M, N and K itself,
so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..common import check_on_card
from .ref import ACTIVATIONS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {act: code for code, act in enumerate(ACTIVATIONS)}


@functools.cache
def _entry():
    fn = _build.load("gemm_os").repro_gemm_os
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gemm_os_cuda(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None,
                 coalesce_grid: bool = False,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: (M, K), b: (K, N) float32 or bfloat16 of one dtype; bias: (N,)
    or None, any float dtype (added in float32); all contiguous on one
    CUDA device.  Returns act(a @ b + bias), (M, N) in ``out_dtype``
    (float32 or bfloat16, default a's)."""
    out_dtype = out_dtype or a.dtype
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm_os kernel takes float32 or bfloat16 a/b of "
                        f"one dtype, got {a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"gemm_os kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if bias is not None and not bias.dtype.is_floating_point:
        raise TypeError(f"bias must be floating point, got {bias.dtype}")
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got "
                         f"{activation!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            (bias is not None and bias.shape != (b.shape[1],)):
        raise ValueError(
            f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, K, N) == 0:
        raise ValueError(f"empty product: M={M}, K={K}, N={N}")
    check_on_card([("a", a), ("b", b)]
                  + ([("bias", bias)] if bias is not None else []))
    if bias is not None:
        bias = bias.float()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry()(a.data_ptr(), b.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), M, N, K, _DTYPES[a.dtype],
                       _DTYPES[out_dtype], _ACTS[activation],
                       int(coalesce_grid), stream)
    if err != 0:
        raise RuntimeError(f"gemm_os kernel launch failed: CUDA error {err}")
    return out
