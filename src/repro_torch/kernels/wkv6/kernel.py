"""Launcher of the hand-written Hopper WKV6 kernel (``csrc/wkv6.cu``),
bound with ctypes.

One thread owns one column of a (batch, head)'s D x D state for the whole
call; the columns are split across blocks of 32, so a batch-1 prefill
still spreads over D / 32 * H blocks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..common import check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def _entry():
    fn = _build.load("wkv6").repro_wkv6
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D) of one dtype; u: (H, D) float32; state0:
    (B, H, D, D) float32 or None (zeros).  All contiguous on one CUDA
    device.  Returns (out (B, T, H, D) in r's dtype, state (B, H, D, D)
    float32)."""
    B, T, H, D = r.shape
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r/k/v/w of "
                        f"one dtype, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if u.dtype != torch.float32 or (state0 is not None
                                    and state0.dtype != torch.float32):
        raise TypeError("wkv6 kernel takes u and state0 in float32")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel is built for D in {HEAD_DIMS}, "
                         f"got D={D}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, D) or \
            (state0 is not None and state0.shape != (B, H, D, D)):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"state0 {None if state0 is None else tuple(state0.shape)}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if state0 is not None:
        named.append(("state0", state0))
    check_on_card(named)
    for name, t in named:
        if t.data_ptr() % 16:     # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(),
                       None if state0 is None else state0.data_ptr(),
                       out.data_ptr(), state.data_ptr(), B, T, H, D,
                       _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    return out, state
