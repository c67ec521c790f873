"""Launchers of the hand-written Hopper WKV6 kernels (``csrc/wkv6.cu``),
bound with ctypes.

Two routes, one C entry point each; ``route`` picks one from the shape
before the launch:

* ``step``: one thread owns one column of a (batch, head)'s D x D state
  for all T steps; the columns are split across blocks of 32, so a
  batch-1 call spreads over D / 32 * H blocks.  Decode (T = 1) and
  prompts shorter than one chunk (``CHUNK_T`` steps).
* ``chunked``: T is cut into chunks of ``CHUNK_T`` steps that run the
  same recurrence in parallel from a zero state, a scan over the chunks
  carries the state (only products of decays, no division), and a
  correction adds each chunk's carried-in state to its outputs.  Three
  launches in one C call, with float32 scratch from PyTorch's allocator.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..common import cdiv, check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
ROUTES = ("step", "chunked")
CHUNK_T = 64          # steps a chunk of the chunked route covers


@functools.cache
def _entries():
    lib = _build.load("wkv6")
    step = lib.repro_wkv6
    step.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    step.restype = ctypes.c_int
    chunked = lib.repro_wkv6_chunked
    chunked.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    chunked.restype = ctypes.c_int
    return {"step": step, "chunked": chunked}


def route(B: int, T: int, H: int, D: int) -> str:
    """The route of a call of ``T`` steps: ``chunked`` from one whole
    chunk (``CHUNK_T`` steps) up, else ``step``.  Timed on an H100 at
    rwkv6-1.6b's heads and batch 1 (``chip_smoke.py`` times both routes
    at T 48 and 64), the chunked route is the faster from about T 32; one
    threshold at one chunk keeps decode and short prompts on the step
    kernel and every prefill of rwkv6-1.6b's serving episode (prompts of
    64 to 1024) on the chunked route.  B, H and D do not move the rule."""
    del B, H, D
    return "chunked" if T >= CHUNK_T else "step"


def _chunked_scratch(B: int, T: int, H: int, D: int,
                    device: torch.device):
    """The chunked route's float32 scratch, from PyTorch's allocator:
    local outputs (B, T, H, D), chunk end states (B, chunks, H, D, D) and
    decay products (B, chunks, H, D) in one tensor.  Returns the tensor
    (kept alive until the launch is queued) and the three pointers."""
    n_chunks = cdiv(T, CHUNK_T)
    n_local = B * T * H * D
    n_states = B * n_chunks * H * D * D
    scratch = torch.empty(n_local + n_states + B * n_chunks * H * D,
                          dtype=torch.float32, device=device)
    base = scratch.data_ptr()
    return scratch, (base, base + 4 * n_local,
                     base + 4 * (n_local + n_states))


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D) of one dtype; u: (H, D) float32; state0:
    (B, H, D, D) float32 or None (zeros).  All contiguous on one CUDA
    device.  Runs on ``route``'s route.  Returns (out (B, T, H, D) in r's
    dtype, state (B, H, D, D) float32, the route that ran)."""
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
    kind = route(B, T, H, D)
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if state0 is not None:
        named.append(("state0", state0))
    check_on_card(named)
    for name, t in named:
        if t.data_ptr() % 16:     # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    s0 = None if state0 is None else state0.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0, out.data_ptr(), state.data_ptr())
        if kind == "step":
            err = _entries()["step"](*args, B, T, H, D, _DTYPES[r.dtype],
                                     stream)
        else:
            scratch, ptrs = _chunked_scratch(B, T, H, D, r.device)
            err = _entries()["chunked"](*args, *ptrs, B, T, H, D, CHUNK_T,
                                        _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed ({kind} route): "
                           f"CUDA error {err}")
    return out, state, kind
