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
  the card.  The split operands take 2 (M + N) K floats, twice the
  inputs, so the scratch is capped at ``TF32X3_SCRATCH_BYTES``: a product
  past the cap runs as panel products under it (``tf32x3_panels``: row
  panels of A times column panels of B, whole tiles, the whole K, each
  panel split once where the cap allows), every C tile computed exactly
  as in one whole call.  llama3.2-1b's ffn_in site (M 1024, K 2048, N
  8192; 151 MB) is one panel.  K so deep that one full wave of tiles
  would not fit under the cap goes to SIMT (``route``).
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
# tf32x3 blocks resident on an SM, by tile (193 KB and 97 KB of shared
# memory in the source)
TF32X3_BLOCKS_PER_SM = {128: 1, 64: 2}
# The tf32x3 route's scratch (the split operands of one panel product) at
# most: 2.5% of the H100's 80 GB.  At this cap a 60000^3 product runs as
# panels of 12 x 22 tiles of 128 x 128 (two full waves each); at 256 MiB
# it would be panels of 4 tiles on 4 of the 132 SMs.
TF32X3_SCRATCH_BYTES = 2 << 30


class Route(NamedTuple):
    """Which kernel runs and the tile of C each of its blocks owns."""
    kind: str
    block_m: int
    block_n: int


class Panel(NamedTuple):
    """One tf32x3 panel product: rows m0 .. m0 + m of A and C times
    columns n0 .. n0 + n of B and C, over the whole K; ``split_a`` /
    ``split_b`` say whether it writes the panel's split A / B into the
    scratch first, or reuses what the panel product before it left."""
    m0: int
    m: int
    n0: int
    n: int
    split_a: bool
    split_b: bool


def route(M: int, K: int, N: int, dtype: torch.dtype,
          aligned: bool = True) -> Route:
    """The route of an (M, K) @ (K, N) product of ``dtype`` inputs;
    ``aligned`` says whether every pointer is 16-byte aligned.  TMA needs
    row strides that are multiples of 16 bytes (K and N multiples of 8 in
    bfloat16, of 4 in float32) and aligned bases; everything else runs on
    the SIMT kernel.  float32 goes to the tensor cores only as three TF32
    products (``tf32x3``), which hold the 1e-4 float32 tolerance that one
    TF32 product would not, and only where one full wave of its tiles
    (``CARD_SMS`` of them, or all the product has) over the whole K fits
    its split operands under ``TF32X3_SCRATCH_BYTES``: past about K 91000
    on the 128 x 128 tile (12 x 11 tiles), 182000 on the 64 x 64 one,
    panels under the cap would leave SMs idle, and the product runs on
    SIMT.  That is a rule of the shape, not a fallback."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        if M <= SMALL_M:
            return Route("tensor_core", 64, 64)
        return Route("tensor_core", 128, 128)
    if dtype == torch.float32 and K % 4 == 0 and N % 4 == 0 and aligned:
        tile = 64 if M <= SMALL_M or \
            cdiv(M, 128) * cdiv(N, 128) < CARD_SMS else 128
        if 8 * K * _wave_rows(M, N, tile) <= TF32X3_SCRATCH_BYTES:
            return Route("tf32x3", tile, tile)
    return Route("simt", 128, 128)


def _wave_rows(M: int, N: int, tile: int) -> int:
    """The fewest rows of A plus columns of B that a panel pair of at
    least one full wave of ``tile`` x ``tile`` tiles (``CARD_SMS``, or
    every tile where the product has fewer) holds."""
    gm, gn = cdiv(M, tile), cdiv(N, tile)
    wave = min(CARD_SMS, gm * gn)
    return min(min(tm * tile, M) + min(cdiv(wave, tm) * tile, N)
               for tm in range(1, gm + 1) if cdiv(wave, tm) <= gn)


def tf32x3_panels(M: int, K: int, N: int, block_m: int, block_n: int,
                  cap: int = TF32X3_SCRATCH_BYTES) -> list:
    """The panel products of a tf32x3 call, in launch order: one whole
    panel where 2 (M + N) K floats fit in ``cap`` bytes, else row panels
    of A of ``tm`` tiles times column panels of B of ``tn`` tiles, the
    split operands of a pair under the cap.  Of the pairs that fit, the
    one with the fewest waves of tiles over all the panel products (a
    wave: ``CARD_SMS`` times ``TF32X3_BLOCKS_PER_SM`` tiles) and then the
    fewest panels.  The loop runs over the panels of one operand outside
    and the other's inside, whichever splits fewer floats again: the
    outer panel is split once, the inner ones once each outer panel
    (once in all where there is one).  Raises ValueError where not even
    one tile's pair fits."""
    limit = cap // (8 * K)          # rows of A plus columns of B a pair holds
    if M + N <= limit:
        return [Panel(0, M, 0, N, True, True)]
    gm, gn = cdiv(M, block_m), cdiv(N, block_n)
    slots = CARD_SMS * TF32X3_BLOCKS_PER_SM.get(block_m, 1)

    def waves(tm, tn):
        out = 0
        for cm, rows in ((gm // tm, tm), (1, gm % tm)):
            for cn, cols in ((gn // tn, tn), (1, gn % tn)):
                if rows and cols:
                    out += cm * cn * cdiv(rows * cols, slots)
        return out

    best = None
    for tm in range(1, gm + 1):
        tn = min(gn, (limit - min(tm * block_m, M)) // block_n)
        if tn < 1:
            break
        key = (waves(tm, tn), cdiv(gm, tm) * cdiv(gn, tn))
        if best is None or key < best[0]:
            best = (key, tm, tn)
    if best is None:
        raise ValueError(f"tf32x3 at K={K}: one {block_m} x {block_n} tile's "
                         f"split operands pass the {cap}-byte scratch cap")
    _, tm, tn = best
    pm, pn = tm * block_m, tn * block_n
    rows = [(m0, min(pm, M - m0)) for m0 in range(0, M, pm)]
    cols = [(n0, min(pn, N - n0)) for n0 in range(0, N, pn)]
    # floats split: B outside, A inside; or A outside, B inside
    a_inside = (len(cols) if len(rows) > 1 else 1) * M + N
    b_inside = M + (len(rows) if len(cols) > 1 else 1) * N
    panels = []
    if a_inside <= b_inside:
        for j, (n0, n) in enumerate(cols):
            for i, (m0, m) in enumerate(rows):
                panels.append(Panel(m0, m, n0, n, len(rows) > 1 or j == 0,
                                    i == 0))
    else:
        for i, (m0, m) in enumerate(rows):
            for j, (n0, n) in enumerate(cols):
                panels.append(Panel(m0, m, n0, n, j == 0,
                                    len(cols) > 1 or i == 0))
    return panels


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
                     + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
                     + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    tf32.restype = ctypes.c_int
    return simt, tc, tf32


def _panel_scratch(panels: list, K: int) -> Tuple[int, int]:
    """Floats of the split A of the largest row panel, (2 Pm, K), and of
    the split B^T of the largest column panel, (2 Pn, K)."""
    return (2 * K * max(p.m for p in panels),
            2 * K * max(p.n for p in panels))


def tf32x3_scratch_floats(M: int, K: int, N: int) -> int:
    """float32 scratch of a tf32x3 call on ``route``'s tile: the split
    operands of its largest panel pair (``tf32x3_panels``); 2 (M + N) K
    for a call of one panel."""
    r = route(M, K, N, torch.float32)
    return sum(_panel_scratch(
        tf32x3_panels(M, K, N, r.block_m, r.block_n), K))


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
            panels = tf32x3_panels(M, K, N, r.block_m, r.block_n)
            a_floats, b_floats = _panel_scratch(panels, K)
            scratch = torch.empty(a_floats + b_floats, dtype=torch.float32,
                                  device=a.device)
            a2 = scratch.data_ptr()
            for p in panels:
                err = tf32(*ptrs, a2, a_floats, a2 + 4 * a_floats, b_floats,
                           p.m0, p.n0, p.m, p.n, K, N, N, int(p.split_a),
                           int(p.split_b), _DTYPES[out_dtype],
                           _ACTS[activation], int(coalesce_grid), r.block_m,
                           r.block_n, stream)
                if err != 0:
                    break
        else:
            err = simt(*args, _DTYPES[a.dtype], _DTYPES[out_dtype],
                       _ACTS[activation], int(coalesce_grid), stream)
    if err != 0:
        raise RuntimeError(f"gemm_os kernel launch failed ({r.kind} "
                           f"route): CUDA error {err}")
    return out, r
