"""Launchers of the hand-written Hopper WKV6 kernels (``csrc/wkv6.cu``),
bound with ctypes.

Three routes, one C entry point each; ``route`` picks one from the shape
before the launch:

* ``decode``: one step (T = 1) at D in ``HEAD_DIMS``, with or without a
  state: a block of D^2 / 16 threads (D^2 / 32 at D 128) a (batch,
  head), each owning a slice of rows x 4 columns of the state, every load
  issued before the arithmetic (the state as 16-byte vectors, r, k, w, u
  and v once each), the output's sum over d reduced by shuffles and
  shared memory in a fixed order, the new state out by streaming stores.
  Its own C entry (``repro_wkv6_decode``) and its own count in
  ``wkv6.launches_by_route``.
* ``step``: one thread owns one column of a (batch, head)'s D x D state
  for all T steps; the columns are split across blocks of 32, so a
  batch-1 call spreads over D / 32 * H blocks.  Prompts shorter than one
  chunk (``CHUNK_T`` steps), and T = 1 at other D.
* ``chunked``: T is cut into chunks of ``CHUNK_T`` steps that run the
  same recurrence in parallel from a zero state, a scan over the chunks
  carries the state (only products of decays, no division), and a
  correction adds each chunk's carried-in state to its outputs.  Three
  launches in one C call, with float32 scratch from PyTorch's allocator.

``step`` and ``chunked`` take any head size D >= 1: D in ``HEAD_DIMS``
runs on the kernels instantiated for it, every other D on the source's
``wkv6_any_kernel`` (one thread a column of the state, D a runtime
value), inside the same C entry points.

The gradient has its own kernels (``csrc/wkv6_backward.cu``,
``wkv6_backward_cuda``), for any D >= 1 and T >= 1, whichever route the
forward took; ``backward_route`` picks one of three routes from the shape
before the launch:

* ``parallel`` (D in ``BWD_HEAD_DIMS``, any T): chunks of
  ``BWD_CHUNK_T`` steps all at once.  The forward's local and scan
  kernels give the state at each chunk's entry (the source's
  ``repro_wkv6_chunk_states`` at this chunk length), the gradient's own
  local and scan kernels the state gradient at each chunk's exit; then one
  block a (batch, head, chunk) recomputes the chunk's states on chip and
  walks them back.
* ``chunked`` / ``step`` (every other D; T over ``CHUNK_T`` or not): the
  first backward kernel, which walks the chunks of ``CHUNK_T`` steps one
  after another from the last, a thread a row or column of the state.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..common import cdiv, check_on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)   # D the fast kernels are instantiated for
ROUTES = ("decode", "step", "chunked")
CHUNK_T = 64          # steps a chunk of the chunked route covers
BACKWARD_ROUTES = ("step", "chunked", "parallel")
BWD_HEAD_DIMS = (16, 32, 64)   # D the parallel backward is built for
BWD_CHUNK_T = 16      # steps a chunk of the parallel backward covers


@functools.cache
def _entries():
    lib = _build.load("wkv6")
    step = lib.repro_wkv6
    step.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    step.restype = ctypes.c_int
    decode = lib.repro_wkv6_decode
    decode.argtypes = step.argtypes
    decode.restype = ctypes.c_int
    chunked = lib.repro_wkv6_chunked
    chunked.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    chunked.restype = ctypes.c_int
    states = lib.repro_wkv6_chunk_states
    states.argtypes = chunked.argtypes
    states.restype = ctypes.c_int
    return {"decode": decode, "step": step, "chunked": chunked,
            "states": states}


@functools.cache
def _backward_entries():
    lib = _build.load("wkv6_backward")
    out = {}
    for kind, name in (("serial", "repro_wkv6_backward"),
                       ("parallel", "repro_wkv6_backward_parallel")):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out[kind] = fn
    return out


def route(B: int, T: int, H: int, D: int) -> str:
    """The route of a call of ``T`` steps: ``decode`` for one step at D in
    ``HEAD_DIMS``; ``chunked`` from one whole chunk (``CHUNK_T`` steps)
    up; else ``step``.  Timed on an H100 at rwkv6-1.6b's heads and batch 1
    (``chip_smoke.py`` times both routes at T 48 and 64), the chunked
    route is the faster from about T 32; one threshold at one chunk keeps
    short prompts on the step kernel and every prefill of rwkv6-1.6b's
    serving episode (prompts of 64 to 1024) on the chunked route.  B and H
    do not move the rule."""
    del B, H
    if T == 1 and D in HEAD_DIMS:
        return "decode"
    return "chunked" if T >= CHUNK_T else "step"


def backward_route(B: int, T: int, H: int, D: int) -> str:
    """The backward kernel's route: ``parallel`` for D in
    ``BWD_HEAD_DIMS`` at any T (rwkv6's D 64: the chunks run at once),
    else the first kernel, ``chunked`` where T spans more than one chunk
    of ``CHUNK_T`` steps and ``step`` within one.  B and H do not move
    the rule."""
    del B, H
    if D in BWD_HEAD_DIMS:
        return "parallel"
    return "chunked" if T > CHUNK_T else "step"


def _chunked_scratch(B: int, T: int, H: int, D: int,
                     device: torch.device, ct: int = CHUNK_T):
    """The chunked route's float32 scratch, from PyTorch's allocator, for
    chunks of ``ct`` steps: local outputs (B, T, H, D), chunk end states
    (B, chunks, H, D, D) and decay products (B, chunks, H, D) in one
    tensor.  Returns the tensor (kept alive until the launch is queued)
    and the three pointers."""
    n_chunks = cdiv(T, ct)
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
    """r/k/v/w: (B, T, H, D) of one dtype, any D >= 1; u: (H, D)
    float32; state0: (B, H, D, D) float32 or None (zeros).  All contiguous
    on one CUDA device.  Runs on ``route``'s route.  Returns (out (B, T,
    H, D) in r's dtype, state (B, H, D, D) float32, the route that
    ran)."""
    B, T, H, D = r.shape
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r/k/v/w of "
                        f"one dtype, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if u.dtype != torch.float32 or (state0 is not None
                                    and state0.dtype != torch.float32):
        raise TypeError("wkv6 kernel takes u and state0 in float32")
    if D < 1:
        raise ValueError(f"wkv6 kernel is built for D >= 1, got D={D}")
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
        # the kernels built for HEAD_DIMS read 16-byte vectors
        if D in HEAD_DIMS and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    s0 = None if state0 is None else state0.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0, out.data_ptr(), state.data_ptr())
        if kind in ("decode", "step"):
            err = _entries()[kind](*args, B, T, H, D, _DTYPES[r.dtype],
                                   stream)
        else:
            scratch, ptrs = _chunked_scratch(B, T, H, D, r.device)
            err = _entries()["chunked"](*args, *ptrs, B, T, H, D, CHUNK_T,
                                        _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed ({kind} route): "
                           f"CUDA error {err}")
    return out, state, kind


def wkv6_backward_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       state0: Optional[torch.Tensor], g_out: torch.Tensor,
                       g_state: Optional[torch.Tensor] = None,
                       kind: Optional[str] = None):
    """The gradients of ``wkv6_cuda``'s (out, state) given ``g_out``
    (B, T, H, D, in r's dtype) and ``g_state`` (B, H, D, D float32, or
    None for zeros), on the backward kernels; inputs as ``wkv6_cuda``
    takes them.  Runs on ``backward_route``'s route, or on ``kind`` where
    given: the first kernel's route (``chunked`` or ``step``, as T gives
    it) runs at every D, which is how ``chip_smoke.py`` times the kernel
    the parallel route replaced.  Returns (dr, dk, dv, dw in r's dtype, du
    (H, D) float32, dstate0 (B, H, D, D) float32, the route)."""
    B, T, H, D = r.shape
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, w, g_out)):
        raise TypeError(f"wkv6 backward kernel takes float32 or bfloat16 "
                        f"r/k/v/w/g_out of one dtype, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}, {w.dtype}, {g_out.dtype}")
    if any(t is not None and t.dtype != torch.float32
           for t in (u, state0, g_state)):
        raise TypeError("wkv6 backward kernel takes u, state0 and g_state "
                        "in float32")
    if min(B, T, H, D) < 1:
        raise ValueError(f"wkv6 backward kernel takes B, T, H, D >= 1, got "
                         f"{tuple(r.shape)}")
    if any(t.shape != r.shape for t in (k, v, w, g_out)) or \
            u.shape != (H, D) or any(
                t is not None and t.shape != (B, H, D, D)
                for t in (state0, g_state)):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, g_out "
            f"{tuple(g_out.shape)}, u {tuple(u.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}, g_state "
            f"{None if g_state is None else tuple(g_state.shape)}")
    serial = "chunked" if T > CHUNK_T else "step"
    allowed = {backward_route(B, T, H, D), serial}
    if kind is None:
        kind = backward_route(B, T, H, D)
    elif kind not in allowed:
        raise ValueError(f"wkv6 backward at {tuple(r.shape)} runs on "
                         f"{sorted(allowed)}, not {kind!r}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("g_out", g_out)]
    named += [(n, t) for n, t in (("state0", state0), ("g_state", g_state))
              if t is not None]
    check_on_card(named)
    # the parallel route and the forward's kernels built for HEAD_DIMS
    # read 16-byte vectors
    if (kind == "parallel" or (kind == "chunked" and D in HEAD_DIMS)) and \
            any(t.data_ptr() % 16 for _, t in named):
        raise ValueError(f"{', '.join(n for n, _ in named)} must be "
                         f"16-byte aligned")
    ct = BWD_CHUNK_T if kind == "parallel" else CHUNK_T
    n_chunks = cdiv(T, ct)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, D), **f32)
    dstate0 = torch.empty((B, H, D, D), **f32)
    if kind == "parallel":   # du_part, G at the chunks' exits, their decays
        scratch = torch.empty(B * n_chunks * H * D * (2 + D), **f32)
        n_part = B * n_chunks * H * D
        ptrs = (scratch.data_ptr(), scratch.data_ptr() + 4 * n_part,
                scratch.data_ptr() + 4 * n_part * (1 + D))
    else:                    # du_part, one chunk's states, G
        scratch = torch.empty(B * H * D * (1 + (min(T, CHUNK_T) + 1) * D),
                              **f32)
        n_hist = B * H * min(T, CHUNK_T) * D * D
        ptrs = (scratch.data_ptr(), scratch.data_ptr() + 4 * B * H * D,
                scratch.data_ptr() + 4 * (B * H * D + n_hist))
    s0 = None if state0 is None else state0.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        entry = None
        if n_chunks > 1:
            # the chunk entry states, by the chunked route's local and
            # scan passes; their outputs and final state land in dv and
            # dstate0, which the backward kernels then overwrite
            states, sp = _chunked_scratch(B, T, H, D, r.device, ct)
            err = _entries()["states"](
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0, dv.data_ptr(), dstate0.data_ptr(), *sp,
                B, T, H, D, ct, _DTYPES[r.dtype], stream)
            if err != 0:
                raise RuntimeError(f"wkv6 backward: the chunk states' "
                                   f"launch failed: CUDA error {err}")
            entry = sp[1]
        err = _backward_entries()[
            "parallel" if kind == "parallel" else "serial"](
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0, g_out.data_ptr(),
            None if g_state is None else g_state.data_ptr(), entry,
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), dstate0.data_ptr(), *ptrs, B, T, H, D, ct,
            _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward kernel launch failed ({kind} "
                           f"route): CUDA error {err}")
    return dr, dk, dv, dw, du, dstate0, kind
