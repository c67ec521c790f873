"""Launcher of the hand-written Hopper decode-attention kernels
(``csrc/decode_attn.cu``), bound with ctypes.

Two routes, one C entry point each; ``route`` picks one from the dtype,
the head shape and the pointers' alignment before the launch:

* ``tensor_core``: bfloat16 with head_dim in ``HEAD_DIMS``, any group
  G = H / Hkv, 16-byte aligned q/k/v.  A pipelined flash-decode on
  ``mma.sync``: each warp streams its keys through a ring of cp.async
  stages; splits of ``split_plan_tc``.
* ``simt``: float32 (whose 2e-4 tolerance TF32 would break) and every
  other call; float32 FMAs over 16-byte vectors; splits of
  ``split_plan``.

On both the S axis is split across blocks so that a decode batch, which
has only B * Hkv (batch, kv-head) pairs, still fills the card; a second
launch in the same C call merges the splits.  Both take any G: a block
serves one tile of ``group_tile(G, kind)`` query heads, and a grid axis
runs over the ``cdiv(G, tile)`` tiles of a KV head.  A row of length 0
gets the mean of its V over all S rows, as the plain version gives it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from ..common import cdiv, check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
# Query-head tiles each route's kernels are instantiated for (group_tile)
TILES = {"tensor_core": (1, 2, 4, 8, 16), "simt": (1, 2, 4, 8)}
_THREADS = 128            # kThreads in the source
_KEYS = 4                 # kKeys in the source
BLOCKS_PER_SM = 8         # split target: this many split blocks per SM
ROUTES = ("tensor_core", "simt")
TC_TILE = 64              # keys a tensor-core block takes per step (TILE)
TC_MIN_CHUNK = 256        # rows a tensor-core split covers at least
TC_BLOCKS_PER_SM = 2      # tensor-core blocks resident on an SM at D 64


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _entries():
    lib = _build.load("decode_attn")
    simt = lib.repro_decode_attn
    simt.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    simt.restype = ctypes.c_int
    tc = lib.repro_decode_attn_tc
    tc.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    tc.restype = ctypes.c_int
    return simt, tc


def route(D: int, G: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The route of a call with head_dim ``D``, ``G`` query heads per KV
    head and ``dtype`` q/k/v; ``aligned`` says whether q, k and v are
    16-byte aligned.  bfloat16 at a head_dim it is built for goes to the
    tensor cores whatever G is: up to 16 heads are the rows of one m16
    tile, more run as several tiles (``group_tile``), each reading K/V
    once.  Every other call goes to the SIMT kernel, which refuses what it
    cannot take either."""
    del G     # every group runs on either route
    if dtype == torch.bfloat16 and D in HEAD_DIMS and aligned:
        return "tensor_core"
    return "simt"


def group_tile(G: int, kind: str) -> int:
    """Query heads a block of route ``kind`` serves for a group of ``G``:
    the smallest tile the kernels are built for that holds G, else the
    largest (as ``group_tile`` in the source)."""
    return next((t for t in TILES[kind] if t >= G), TILES[kind][-1])


def split_plan(B: int, Hkv: int, S: int, D: int, dtype: torch.dtype,
               n_sms: int):
    """(splits, chunk): chunk is a whole number of the block's steps
    (rows read per loop trip), and there are about BLOCKS_PER_SM split
    blocks per SM when S is long enough."""
    vec = 16 // dtype.itemsize
    step = (_THREADS // (D // vec)) * _KEYS
    want = max(1, cdiv(BLOCKS_PER_SM * n_sms, B * Hkv))
    chunk = cdiv(cdiv(S, min(want, cdiv(S, step))), step) * step
    return cdiv(S, chunk), chunk


def split_plan_tc(B: int, Hkv: int, S: int, n_sms: int):
    """(splits, chunk) of the tensor-core route: chunk is a whole number of
    TC_TILE-key steps and at least TC_MIN_CHUNK rows, so each block's
    cp.async ring reaches its steady state, and the splits are as many as
    keep every block resident at once (TC_BLOCKS_PER_SM an SM) when S is
    long enough."""
    want = max(1, (TC_BLOCKS_PER_SM * n_sms) // (B * Hkv))
    chunk = max(TC_MIN_CHUNK, cdiv(cdiv(S, want), TC_TILE) * TC_TILE)
    return cdiv(S, chunk), chunk


def plan(kind: str, B: int, Hkv: int, G: int, S: int, D: int,
         dtype: torch.dtype, n_sms: int):
    """(splits, chunk) of a call on route ``kind``: its split plan over the
    B * Hkv * tiles blocks a split has."""
    pairs = Hkv * cdiv(G, group_tile(G, kind))
    if kind == "tensor_core":
        return split_plan_tc(B, pairs, S, n_sms)
    return split_plan(B, pairs, S, D, dtype, n_sms)


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float
                     ) -> Tuple[torch.Tensor, str]:
    """q: (B, Hkv, G, D); k/v: (B, Hkv, S, D); lengths: (B,) int32, all
    contiguous on one CUDA device.  Returns ((B, Hkv, G, D) in q's dtype,
    the route that ran)."""
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attn kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if D not in HEAD_DIMS or G < 1:
        raise ValueError(f"decode_attn kernel is built for head_dim in "
                         f"{HEAD_DIMS} and H/Hkv >= 1, got D={D}, G={G}")
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or \
            lengths.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths {tuple(lengths.shape)}")
    check_on_card([("q", q), ("k", k), ("v", v), ("lengths", lengths)])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:     # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    kind = route(D, G, q.dtype)    # every pointer is 16-byte aligned here
    splits, chunk = plan(kind, B, Hkv, G, S, D, q.dtype,
                         _sm_count(q.device.index))
    out = torch.empty_like(q)
    # one float32 scratch for the partials: max and denominator
    # (B, Hkv, splits, G) each, then the sums (B, Hkv, splits, G, D)
    n = B * Hkv * splits * G
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        base = part.data_ptr()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), base, base + 4 * n, base + 8 * n, B, Hkv, G,
                S, D, splits, chunk, float(scale))
        simt, tc = _entries()
        if kind == "tensor_core":
            err = tc(*args, stream)
        else:
            err = simt(*args, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed ({kind} "
                           f"route): CUDA error {err}")
    return out, kind
