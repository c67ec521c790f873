"""Launcher of the hand-written Hopper direct convolution
(``csrc/conv2d_os.cu``), bound with ctypes.

A block owns a 16 x 16 patch of output pixels of one image and 64 output
channels; it walks Cin in chunks of 8, staging the input patch with its
halo and all taps' weights in shared memory.  Ragged Cin, Cout and
output edges are masked in the kernel, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..common import check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TH, TW, BCO, CC and kMaxSmem in the source
TILE, BCO, CC = 16, 64, 8
MAX_SMEM = 232448


def smem_bytes(KH: int, KW: int) -> int:
    """Shared memory of one block: the input patch with its halo, then all
    taps' weights, for one chunk of CC channels, in float32."""
    return 4 * ((TILE + KH - 1) * (TILE + KW - 1) * CC + KH * KW * CC * BCO)


@functools.cache
def _entry():
    fn = _build.load("conv2d_os").repro_conv2d_os
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv2d_os_cuda(x: torch.Tensor, w: torch.Tensor, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (N, H, W, Cin), w: (KH, KW, Cin, Cout), float32 or bfloat16 of
    one dtype, contiguous on one CUDA device.  Returns the valid, stride-1
    convolution (N, H - KH + 1, W - KW + 1, Cout) in ``out_dtype``
    (float32 or bfloat16, default x's)."""
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d_os kernel takes float32 or bfloat16 x/w of "
                        f"one dtype, got {x.dtype}, {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"conv2d_os kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3] or \
            w.shape[0] > x.shape[1] or w.shape[1] > x.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"need x (N, H, W, Cin), w (KH, KW, Cin, Cout) with "
                         f"KH <= H, KW <= W")
    N, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    if min(N, Cin, Cout, KH, KW) == 0 or N > 65535:
        raise ValueError(f"conv2d_os kernel takes 1 <= N <= 65535 and "
                         f"nonempty channels and taps, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if smem_bytes(KH, KW) > MAX_SMEM:
        raise ValueError(f"{KH} x {KW} taps need {smem_bytes(KH, KW)} bytes "
                         f"of shared memory, more than a block has")
    check_on_card([("x", x), ("w", w)])
    out = torch.empty((N, H - KH + 1, W - KW + 1, Cout), dtype=out_dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W,
                       Cin, Cout, KH, KW, _DTYPES[x.dtype],
                       _DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv2d_os kernel launch failed: CUDA error "
                           f"{err}")
    return out
