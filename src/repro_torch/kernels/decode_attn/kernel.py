"""Launcher of the hand-written Hopper decode-attention kernel
(``csrc/decode_attn.cu``), bound with ctypes.

The S axis is split across blocks so that a decode batch, which has only
B * Hkv (batch, kv-head) pairs, still fills the card; a second launch in
the same C call merges the splits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..common import cdiv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)
_THREADS = 128            # kThreads in the source
_KEYS = 4                 # kKeys in the source
BLOCKS_PER_SM = 8         # split target: this many split blocks per SM


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _entry():
    fn = _build.load("decode_attn").repro_decode_attn
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, Hkv, G, D); k/v: (B, Hkv, S, D); lengths: (B,) int32, all
    contiguous on one CUDA device.  Returns (B, Hkv, G, D) in q's dtype."""
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attn kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if D not in HEAD_DIMS or G not in GROUPS:
        raise ValueError(f"decode_attn kernel is built for head_dim in "
                         f"{HEAD_DIMS} and H/Hkv in {GROUPS}, got D={D}, G={G}")
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or \
            lengths.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be "
                             f"on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:     # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    splits, chunk = split_plan(B, Hkv, S, D, q.dtype,
                               _sm_count(q.device.index))
    out = torch.empty_like(q)
    # one float32 scratch for the partials: max and denominator
    # (B, Hkv, splits, G) each, then the sums (B, Hkv, splits, G, D)
    n = B * Hkv * splits * G
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        base = part.data_ptr()
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), base, base + 4 * n,
                       base + 8 * n, B, Hkv, G, S, D, splits, chunk,
                       float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error "
                           f"{err}")
    return out
