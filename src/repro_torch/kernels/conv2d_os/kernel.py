"""Launcher of the hand-written Hopper direct convolution
(``csrc/conv2d_os.cu``), bound with ctypes.

Four routes, one C entry point each; ``route`` picks one from the
shape, the dtype and the pointers' alignment before the launch:

* ``tensor_core``: bfloat16 with Cin and Cout multiples of 8, 16-byte
  aligned pointers and taps whose patch buffers fit in shared memory
  (every tap size up to 10 x 10 does).  An implicit GEMM on
  ``mma.sync``: a block owns 16 x 16 output pixels of one image and 64
  output channels, stages the input patch with its halo in bf16 by
  ``cp.async``, 64 channels at a time, and reads every tap's A fragments
  from it by ``ldmatrix`` at shifted addresses, while each tap's weights
  stream through a ring of stages.
* ``tf32x3``: float32 with Cin and Cout multiples of 4, Cin at least
  ``MIN_TF32_CIN``, 16-byte aligned pointers and taps whose patch
  buffers fit in shared memory (up to 10 x 10).  Each operand is split
  into two TF32 numbers, x = hi + lo (``gemm_os.ref.split_tf32``), and
  each product taken as x_lo w_hi + x_hi w_lo + x_hi w_hi on the TF32
  tensor cores, which holds the 1e-4 float32 bar that one TF32 product
  breaks: a split pass writes the weights' hi and lo tiles into scratch
  this wrapper allocates (``tf32x3_scratch_floats``: 4096 floats per tap,
  chunk of 32 input and tile of 64 output channels, 288 KB at 3 x 3 x 64
  x 64), laid out for ``wgmma``; then a block of 16 x 16 output pixels
  and 64 channels runs the implicit GEMM on ``wgmma``, each thread
  splitting the input values it loads from the staged patch into
  registers (A), 32 channels a step.
* ``simt``: IEEE float32 FMAs (no TF32) for the rest: channels not
  multiples of 4 (float32) or 8 (bfloat16), Listing 2's Cin = 1 among
  them, float32 with fewer than ``MIN_TF32_CIN`` input channels,
  unaligned pointers, and taps whose tensor-core patch would not fit in
  shared memory.  A block owns a 16 x 16 patch of output pixels
  and 64 output channels and walks Cin in chunks of 8, staging the patch
  and all taps' weights.
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
from ..common import cdiv, check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core", "tf32x3", "simt", "stream")
MAX_SMEM = 232448  # kMaxSmem in the source: bytes a block may use
# Constants of the routes in the source (namespaces simt and tc):
# output pixels of a block, output channels, input channels a step
TILE, BCO, CC = 16, 64, 8
TC_TILE, TC_BCO, TC_CC = (16, 16), 64, 64
TC_PSTR, TC_WSTR, TC_STAGES = 2 * TC_CC + 16, 2 * TC_BCO + 16, 2
# tf32x3 (namespace tf32x3): the tensor-core tile, 32 float32 channels a
# step; bytes a staged pixel (128 of data) and a step's split weights (hi
# and lo, 32 x 64 float32 each)
TF32_CC, TF32_PSTR, TF32_WBYTES = 32, 4 * 32 + 16, 2 * 4 * 32 * TC_BCO
TF32_PATCHES, TF32_WSTAGES = 2, 3   # patch buffers, weight stages
STREAM_TAPS = 16   # KWG in the source: taps of one row staged together
# Input channels from which float32 takes tf32x3: on an NVIDIA H100 80GB
# HBM3 at 700 W and 3 x 3 taps the SIMT kernel is 1.5-2x faster at Cin 4
# and 8, about even at 12, slower from 16 on, whatever the output size
# and Cout (chip_smoke.py: _conv_fill_sweep)
MIN_TF32_CIN = 12


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


def tf32_smem_bytes(KH: int, KW: int) -> int:
    """Shared memory of one tf32x3 block: TF32_PATCHES patch buffers of
    (16 + KH - 1) x (16 + KW - 1) pixels at TF32_PSTR bytes, and
    TF32_WSTAGES weight stages of TF32_WBYTES."""
    th, tw = TC_TILE
    return (TF32_PATCHES * (th + KH - 1) * (tw + KW - 1) * TF32_PSTR
            + TF32_WSTAGES * TF32_WBYTES)


def tf32x3_scratch_floats(KH: int, KW: int, Cin: int, Cout: int) -> int:
    """float32 scratch of the tf32x3 route: the split weights, a hi and a
    lo tile of TF32_CC x TC_BCO per (tap, chunk of TF32_CC input channels,
    tile of TC_BCO output channels), zero past Cin and Cout
    (``split_weight_floats`` in the source)."""
    return (2 * TF32_CC * TC_BCO * KH * KW * cdiv(Cin, TF32_CC)
            * cdiv(Cout, TC_BCO))


def _route(kind: str, KH: int, KW: int) -> Route:
    """The Route of ``kind`` at KH x KW taps: its tile and shared memory."""
    if kind == "tensor_core":
        return Route(kind, TC_TILE, TC_BCO, tc_smem_bytes(KH, KW))
    if kind == "tf32x3":
        return Route(kind, TC_TILE, TC_BCO, tf32_smem_bytes(KH, KW))
    if kind == "simt":
        return Route(kind, (TILE, TILE), BCO, smem_bytes(KH, KW))
    return Route(kind, (TILE, TILE), BCO, stream_smem_bytes())


def route(Cin: int, Cout: int, KH: int, KW: int, dtype: torch.dtype,
          aligned: bool = True) -> Route:
    """The route of a convolution with ``dtype`` inputs; ``aligned`` says
    whether every pointer is 16-byte aligned.  16-byte ``cp.async`` copies
    of whole 8-channel groups need Cin and Cout multiples of 8 in
    bfloat16 (of 4 in float32), and the tensor-core blocks' patch buffers
    must fit in shared memory (wide non-square taps fit only the SIMT
    block: from 1 x 32 in bfloat16, 1 x 25 in float32).  float32 goes to
    the tensor cores only as three TF32 products (``tf32x3``), which hold
    the 1e-4 float32 tolerance that one TF32 product would not, and only
    from MIN_TF32_CIN input channels: a tf32x3 step takes TF32_CC = 32
    channels, SIMT's CC = 8, so below that the SIMT kernel does less
    wasted work and is the faster one.  Taps whose SIMT block would not
    fit either go to the streaming kernel, whose block has a fixed
    size."""
    if dtype == torch.bfloat16 and Cin % 8 == 0 and Cout % 8 == 0 and \
            aligned and tc_smem_bytes(KH, KW) <= MAX_SMEM:
        return _route("tensor_core", KH, KW)
    if dtype == torch.float32 and Cin % 4 == 0 and Cout % 4 == 0 and \
            Cin >= MIN_TF32_CIN and aligned and \
            tf32_smem_bytes(KH, KW) <= MAX_SMEM:
        return _route("tf32x3", KH, KW)
    return _route("simt" if smem_bytes(KH, KW) <= MAX_SMEM else "stream",
                  KH, KW)


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
    tf32 = lib.repro_conv2d_os_tf32x3
    tf32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    tf32.restype = ctypes.c_int
    return {"simt": simt, "tensor_core": tc, "tf32x3": tf32,
            "stream": stream}


def conv2d_os_cuda(x: torch.Tensor, w: torch.Tensor, *,
                   out_dtype: Optional[torch.dtype] = None,
                   kind: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Route]:
    """x: (N, H, W, Cin), w: (KH, KW, Cin, Cout), float32 or bfloat16 of
    one dtype, contiguous on one CUDA device.  Returns (the valid, stride-1
    convolution, the route that ran); the convolution is (N, H - KH + 1,
    W - KW + 1, Cout) in ``out_dtype`` (float32 or bfloat16, default
    x's).  ``kind`` runs that route in place of ``route``'s choice, so
    that routes can be compared on the same inputs; its C entry refuses a
    call it cannot take."""
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
    if kind is not None and kind not in ROUTES:
        raise ValueError(f"kind must be one of {ROUTES}, got {kind!r}")
    r = _route(kind, KH, KW) if kind else route(
        Cin, Cout, KH, KW, x.dtype,
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
        elif r.kind == "tf32x3":    # scratch: the split weights
            scratch = torch.empty(tf32x3_scratch_floats(KH, KW, Cin, Cout),
                                  dtype=torch.float32, device=x.device)
            err = fn(*args[:3], scratch.data_ptr(), scratch.numel(),
                     *args[3:], _DTYPES[out_dtype], stream)
        else:
            err = fn(*args, _DTYPES[x.dtype], _DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv2d_os kernel launch failed ({r.kind} "
                           f"route): CUDA error {err}")
    return out, r
