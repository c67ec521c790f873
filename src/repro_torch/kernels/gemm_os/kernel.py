"""Launcher of the hand-written Hopper output-stationary GEMM
(``csrc/gemm_os.cu``), bound with ctypes.

Three routes, one C entry point each; ``route`` picks one from the
shape, the dtype and the pointers' alignment before the launch:

* ``tensor_core``: bfloat16 with K and N multiples of 8 and 16-byte
  aligned pointers (TMA's terms).  wgmma fed by TMA through a ring of
  shared-memory stages; a 128 x 128 tile of C for M > 64, a 64 x 64 tile
  for M <= 64 so that a decode GEMM puts N / 64 blocks on the card.
* ``tf32x3``: float32 with K and N multiples of 4 and 16-byte aligned
  pointers.  Each operand is split into two TF32 numbers, x = hi + lo
  (``ref.split_tf32``), and each product taken as a_lo b_hi + a_hi b_lo +
  a_hi b_hi on the TF32 tensor cores, which holds the 1e-4 float32 bar
  that one TF32 product breaks.  A split pass writes [A_hi; A_lo] and
  [B_hi^T; B_lo^T] (wgmma reads TF32 operands K-major only) into scratch
  this wrapper allocates for the call, then the bf16 route's wgmma + TMA
  block runs on them; 64 x 64 tiles where 128 x 128 ones would not fill
  the card.  The scratch, 2 (M + N) K floats (``tf32x3_scratch_floats``),
  is twice the inputs: 151 MB at llama3.2-1b's ffn_in site (M 1024, K
  2048, N 8192), held only during the call.  A product whose inputs fit
  on the card but whose scratch does not raises torch's out-of-memory
  error; there is no route back to SIMT.
* ``simt``: the rest (IEEE float32 FMAs, no TF32); a 128 x 128 tile, K
  streaming in steps of 8.

All mask ragged M, N and K, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..common import cdiv, check_on_card
from .ref import ACTIVATIONS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {act: code for code, act in enumerate(ACTIVATIONS)}
ROUTES = ("tensor_core", "tf32x3", "simt")
# M up to which the tensor-core routes take the 64 x 64 tile
SMALL_M = 64
# The H100's SMs: the tf32x3 route takes the 64 x 64 tile where fewer
# 128 x 128 tiles than this would leave SMs idle
CARD_SMS = 132


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
    bfloat16, of 4 in float32) and aligned bases; everything else runs on
    the SIMT kernel.  float32 goes to the tensor cores only as three TF32
    products (``tf32x3``), which hold the 1e-4 float32 tolerance that one
    TF32 product would not."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        if M <= SMALL_M:
            return Route("tensor_core", 64, 64)
        return Route("tensor_core", 128, 128)
    if dtype == torch.float32 and K % 4 == 0 and N % 4 == 0 and aligned:
        if M <= SMALL_M or cdiv(M, 128) * cdiv(N, 128) < CARD_SMS:
            return Route("tf32x3", 64, 64)
        return Route("tf32x3", 128, 128)
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
    tf32 = lib.repro_gemm_os_tf32x3
    tf32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    tf32.restype = ctypes.c_int
    return simt, tc, tf32


def tf32x3_scratch_floats(M: int, K: int, N: int) -> int:
    """float32 scratch of the tf32x3 route: the split A, (2M, K), then the
    split B transposed, (2N, K)."""
    return 2 * (M + N) * K


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
    simt, tc, tf32 = _entries()
    ptrs = (a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    args = (*ptrs, M, N, K)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if r.kind == "tensor_core":
            err = tc(*args, _DTYPES[out_dtype], _ACTS[activation],
                     int(coalesce_grid), r.block_m, r.block_n, stream)
        elif r.kind == "tf32x3":
            scratch = torch.empty(tf32x3_scratch_floats(M, K, N),
                                  dtype=torch.float32, device=a.device)
            err = tf32(*ptrs, scratch.data_ptr(), scratch.numel(), M, N, K,
                       _DTYPES[out_dtype], _ACTS[activation],
                       int(coalesce_grid), r.block_m, r.block_n, stream)
        else:
            err = simt(*args, _DTYPES[a.dtype], _DTYPES[out_dtype],
                       _ACTS[activation], int(coalesce_grid), stream)
    if err != 0:
        raise RuntimeError(f"gemm_os kernel launch failed ({r.kind} "
                           f"route): CUDA error {err}")
    return out, r
