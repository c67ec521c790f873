"""Launcher of the hand-written Hopper output-stationary GEMM
(``csrc/gemm_os.cu``), bound with ctypes.

Two routes, one C entry point each; ``route`` picks one from the shape,
the dtype and the pointers' alignment before the launch:

* ``tensor_core``: bfloat16 with K and N multiples of 8 and 16-byte
  aligned pointers (TMA's terms).  wgmma fed by TMA through a ring of
  shared-memory stages; a 128 x 128 tile of C for M > 64, a 64 x 64 tile
  for M <= 64 so that a decode GEMM puts N / 64 blocks on the card.
* ``simt``: float32 (IEEE FMAs, no TF32) and the bfloat16 shapes TMA
  cannot take; a 128 x 128 tile, K streaming in steps of 8.

Both mask ragged M, N and K, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..common import check_on_card
from .ref import ACTIVATIONS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {act: code for code, act in enumerate(ACTIVATIONS)}
ROUTES = ("tensor_core", "simt")
# M up to which the tensor-core route takes the 64 x 64 tile
SMALL_M = 64


class Route(NamedTuple):
    """Which kernel runs and the tile of C each of its blocks owns."""
    kind: str
    block_m: int
    block_n: int


def route(M: int, K: int, N: int, dtype: torch.dtype,
          aligned: bool = True) -> Route:
    """The route of an (M, K) @ (K, N) product of ``dtype`` inputs;
    ``aligned`` says whether every pointer is 16-byte aligned.  TMA needs
    row strides that are multiples of 16 bytes (K and N multiples of 8 in
    bfloat16) and aligned bases; float32 stays on the SIMT kernel, whose
    IEEE FMAs hold the 1e-4 float32 tolerance that TF32 would not."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        if M <= SMALL_M:
            return Route("tensor_core", 64, 64)
        return Route("tensor_core", 128, 128)
    return Route("simt", 128, 128)


@functools.cache
def _entries():
    lib = _build.load("gemm_os")
    simt = lib.repro_gemm_os
    simt.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    simt.restype = ctypes.c_int
    tc = lib.repro_gemm_os_tc
    tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    tc.restype = ctypes.c_int
    return simt, tc


def gemm_os_cuda(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None,
                 coalesce_grid: bool = False,
                 out_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, Route]:
    """a: (M, K), b: (K, N) float32 or bfloat16 of one dtype; bias: (N,)
    or None, any float dtype (added in float32); all contiguous on one
    CUDA device.  Returns (act(a @ b + bias), the route that ran); the
    product is (M, N) in ``out_dtype`` (float32 or bfloat16, default
    a's)."""
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
    # out comes from torch.empty, whose allocations are aligned
    r = route(M, K, N, a.dtype, all(t.data_ptr() % 16 == 0 for t in (a, b)))
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    simt, tc = _entries()
    args = (a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N,
            K)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if r.kind == "tensor_core":
            err = tc(*args, _DTYPES[out_dtype], _ACTS[activation],
                     int(coalesce_grid), r.block_m, r.block_n, stream)
        else:
            err = simt(*args, _DTYPES[a.dtype], _DTYPES[out_dtype],
                       _ACTS[activation], int(coalesce_grid), stream)
    if err != 0:
        raise RuntimeError(f"gemm_os kernel launch failed ({r.kind} "
                           f"route): CUDA error {err}")
    return out, r
