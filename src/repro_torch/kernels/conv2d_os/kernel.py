"""Launcher of the hand-written Hopper direct convolution
(``csrc/conv2d_os.cu``), bound with ctypes.

Two routes, one C entry point each; ``route`` picks one from the shape,
the dtype and the pointers' alignment before the launch:

* ``tensor_core``: bfloat16 with Cin and Cout multiples of 8, 16-byte
  aligned pointers and taps whose patch buffers fit in shared memory
  (every tap size up to 10 x 10 does).  An implicit GEMM on
  ``mma.sync``: a block owns 16 x 16 output pixels of one image and 64
  output channels, stages the input patch with its halo in bf16 by
  ``cp.async``, 64 channels at a time, and reads every tap's A fragments
  from it by ``ldmatrix`` at shifted addresses, while each tap's weights
  stream through a ring of stages.
* ``simt``: float32 (IEEE FMAs, no TF32), the bfloat16 shapes whose
  channels are not multiples of 8 (Listing 2's Cin = 1 among them) and
  the bfloat16 taps whose tensor-core patch would not fit in shared
  memory.  A block owns a 16 x 16 patch of output pixels and 64 output
  channels and walks Cin in chunks of 8, staging the patch and all taps'
  weights.
* ``stream``: the taps whose SIMT block would not fit in shared memory
  (11 x 11 and larger, 1 x 88 and wider).  The SIMT kernel's tile,
  threads and sum order, but per tap row and group of ``STREAM_TAPS``
  taps it stages only the input rows and weights that group needs, in a
  fixed 48,640 bytes.

All mask ragged Cin, Cout and output edges, so nothing is padded, and
take any batch N: a launch covers at most 65535 images (grid.z), so a
larger batch is launched in slices inside one C call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..common import check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core", "simt", "stream")
MAX_SMEM = 232448  # kMaxSmem in the source: bytes a block may use
# Constants of the two routes in the source (namespaces simt and tc):
# output pixels of a block, output channels, input channels a step
TILE, BCO, CC = 16, 64, 8
TC_TILE, TC_BCO, TC_CC = (16, 16), 64, 64
TC_PSTR, TC_WSTR, TC_STAGES = 2 * TC_CC + 16, 2 * TC_BCO + 16, 2
STREAM_TAPS = 16   # KWG in the source: taps of one row staged together


class Route(NamedTuple):
    """Which kernel runs, the output pixels (rows, columns) and channels
    each of its blocks owns, and its shared memory in bytes."""
    kind: str
    tile: Tuple[int, int]
    block_co: int
    smem: int


def smem_bytes(KH: int, KW: int) -> int:
    """Shared memory of one SIMT block: the input patch with its halo,
    then all taps' weights, for one chunk of CC channels, in float32."""
    return 4 * ((TILE + KH - 1) * (TILE + KW - 1) * CC + KH * KW * CC * BCO)


def stream_smem_bytes() -> int:
    """Shared memory of one streaming block, whatever the taps: TILE input
    rows of TILE + STREAM_TAPS - 1 pixels and STREAM_TAPS taps' weights,
    CC channels deep, in float32."""
    return 4 * (TILE * (TILE + STREAM_TAPS - 1) * CC
                + STREAM_TAPS * CC * BCO)


def tc_smem_bytes(KH: int, KW: int) -> int:
    """Shared memory of one tensor-core block: TC_STAGES patch buffers of
    (16 + KH - 1) x (16 + KW - 1) pixels at TC_PSTR bytes, and TC_STAGES
    weight stages of TC_CC rows at TC_WSTR bytes."""
    th, tw = TC_TILE
    return TC_STAGES * ((th + KH - 1) * (tw + KW - 1) * TC_PSTR
                        + TC_CC * TC_WSTR)


def route(Cin: int, Cout: int, KH: int, KW: int, dtype: torch.dtype,
          aligned: bool = True) -> Route:
    """The route of a convolution with ``dtype`` inputs; ``aligned`` says
    whether every pointer is 16-byte aligned.  16-byte ``cp.async`` copies
    of whole 8-channel groups need Cin and Cout multiples of 8 in
    bfloat16, and the tensor-core block's patch buffers must fit in shared
    memory (wide non-square taps, such as 1 x 32 and wider, fit only the
    SIMT block); float32 stays on the SIMT kernel, whose IEEE FMAs hold
    the 1e-4 float32 tolerance.  Taps whose SIMT block would not fit
    either go to the streaming kernel, whose block has a fixed size."""
    if dtype == torch.bfloat16 and Cin % 8 == 0 and Cout % 8 == 0 and \
            aligned and tc_smem_bytes(KH, KW) <= MAX_SMEM:
        return Route("tensor_core", TC_TILE, TC_BCO, tc_smem_bytes(KH, KW))
    if smem_bytes(KH, KW) <= MAX_SMEM:
        return Route("simt", (TILE, TILE), BCO, smem_bytes(KH, KW))
    return Route("stream", (TILE, TILE), BCO, stream_smem_bytes())


@functools.cache
def _entries():
    lib = _build.load("conv2d_os")
    simt = lib.repro_conv2d_os
    simt.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    simt.restype = ctypes.c_int
    tc = lib.repro_conv2d_os_tc
    tc.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    tc.restype = ctypes.c_int
    stream = lib.repro_conv2d_os_stream
    stream.argtypes = simt.argtypes
    stream.restype = ctypes.c_int
    return {"simt": simt, "tensor_core": tc, "stream": stream}


def conv2d_os_cuda(x: torch.Tensor, w: torch.Tensor, *,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, Route]:
    """x: (N, H, W, Cin), w: (KH, KW, Cin, Cout), float32 or bfloat16 of
    one dtype, contiguous on one CUDA device.  Returns (the valid, stride-1
    convolution, the route that ran); the convolution is (N, H - KH + 1,
    W - KW + 1, Cout) in ``out_dtype`` (float32 or bfloat16, default
    x's)."""
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
    if min(N, Cin, Cout, KH, KW) == 0:
        raise ValueError(f"conv2d_os kernel takes a nonempty batch, "
                         f"channels and taps, got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    # out comes from torch.empty, whose allocations are aligned
    r = route(Cin, Cout, KH, KW, x.dtype,
              all(t.data_ptr() % 16 == 0 for t in (x, w)))
    check_on_card([("x", x), ("w", w)])
    out = torch.empty((N, H - KH + 1, W - KW + 1, Cout), dtype=out_dtype,
                      device=x.device)
    fn = _entries()[r.kind]
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, Cin, Cout,
            KH, KW)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if r.kind == "tensor_core":
            err = fn(*args, _DTYPES[out_dtype], stream)
        else:
            err = fn(*args, _DTYPES[x.dtype], _DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv2d_os kernel launch failed ({r.kind} "
                           f"route): CUDA error {err}")
    return out, r
