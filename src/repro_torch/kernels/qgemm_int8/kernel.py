"""Launcher of the hand-written Hopper int8 GEMM (``csrc/qgemm_int8.cu``),
bound with ctypes.

Two routes, one C entry point each; ``route`` picks one from the shape,
the dtype and the pointers' alignment before the launch:

* ``tensor_core``: K and N multiples of 16 (TMA's row strides) and
  16-byte aligned pointers.  wgmma s8 fed by TMA through a ring of
  shared-memory stages, B's tiles transposed to K-major in the block; a
  256 x 128 tile of C.
* ``simt``: every other shape, on ``__dp4a``; a 128 x 128 tile, K
  streaming in steps of 32.

On both a block keeps its int32 accumulator on chip and applies the
scales once at the end in the plain version's order, so the output
agrees with it bit for bit.  Both mask ragged M, N and K.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from ..common import check_on_card

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core", "simt")
# The largest K whose int32 sums cannot wrap: |a * b| <= 128^2 for int8,
# and K * 128^2 must stay at or below 2^31 - 1.
K_MAX = (2 ** 31 - 1) // 128 ** 2


def check_k(K: int) -> None:
    if K > K_MAX:
        raise ValueError(f"K={K} could wrap the int32 accumulator; "
                         f"qgemm_int8 takes K <= {K_MAX}")


def route(M: int, K: int, N: int, dtype: torch.dtype = torch.int8,
          aligned: bool = True) -> str:
    """The route of an (M, K) @ (K, N) product of ``dtype`` inputs;
    ``aligned`` says whether every pointer is 16-byte aligned.  TMA needs
    row strides that are multiples of 16 bytes (K and N multiples of 16
    in int8) and aligned bases; every other call, a dtype the kernels do
    not take among them (which the SIMT launcher then refuses), goes to
    the SIMT kernel."""
    if dtype == torch.int8 and K % 16 == 0 and N % 16 == 0 and aligned:
        return "tensor_core"
    return "simt"


@functools.cache
def _entries():
    lib = _build.load("qgemm_int8")
    entries = (lib.repro_qgemm_int8, lib.repro_qgemm_int8_tc)
    for fn in entries:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return entries


def qgemm_int8_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                    b_scale: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, str]:
    """a: (M, K), b: (K, N) int8; a_scale: (M,), b_scale: (N,) float32;
    all contiguous on one CUDA device.  Returns ((M, N) in ``out_dtype``
    (float32 or bfloat16), the route that ran)."""
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
    if a.data_ptr() % 4:     # the SIMT kernel reads a's rows in 4-byte words
        raise ValueError("a must be 4-byte aligned")
    # out comes from torch.empty, whose allocations are aligned
    kind = route(M, K, N, a.dtype,
                 all(t.data_ptr() % 16 == 0 for t in (a, b)))
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    simt, tc = _entries()
    fn = tc if kind == "tensor_core" else simt
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                 b_scale.data_ptr(), out.data_ptr(), M, N, K,
                 _OUT_DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"qgemm_int8 kernel launch failed ({kind} "
                           f"route): CUDA error {err}")
    return out, kind
