"""The RWKV6 WKV recurrence: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``wkv6.launches`` counts the kernel's launches, so a run can show that
its main path went through the kernel, and ``wkv6.launches_by_route`` the
launches of each route (``kernel.route``: ``decode``, ``step`` or
``chunked``; the chunked route's three kernels are one C call and count
as one launch).

On the card the kernel runs inside an ``autograd.Function``: its forward
is the kernel, its backward ``wkv6_backward``, the backward kernels
(``csrc/wkv6_backward.cu``), which count their own launches the same way,
by ``kernel.backward_route`` (``parallel`` for rwkv6's D 64: the chunks'
entry states and exit gradients by two chunk scans, then every chunk at
once; the first kernel's ``step`` / ``chunked`` for other D); a call's
kernels are one launch.  The reference trains through its ``lax.scan``
and has no backward kernel.  On the CPU ``wkv6_ref`` is differentiable
as it stands.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import note_cost, shape_only, to_local
from .kernel import (BACKWARD_ROUTES, CHUNK_T, ROUTES, wkv6_backward_cuda,
                     wkv6_cuda)
from .ref import wkv6_backward_ref, wkv6_ref


class _WKV6(torch.autograd.Function):
    """The kernel's forward and the backward kernel (see the module
    note)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, state, kind = wkv6_cuda(r, k, v, w, u, state0)
        wkv6.launches += 1
        wkv6.launches_by_route[kind] += 1
        note_cost("wkv6", *wkv6_cost(*r.shape, r.element_size(),
                                     state0 is not None))
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)    # an unused state: g_state None
        return out, state

    @staticmethod
    def backward(ctx, g_out, g_state):
        r = ctx.saved_tensors[0]
        if g_out is None:
            g_out = torch.zeros_like(r)
        grads = wkv6_backward(*ctx.saved_tensors, g_out, g_state)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor], g_out: torch.Tensor,
                  g_state: Optional[torch.Tensor] = None):
    """The gradients (dr, dk, dv, dw, du, dstate0) of ``wkv6``'s (out,
    state) given ``g_out`` and ``g_state`` (None: zeros): the backward
    kernels on CUDA tensors, on ``kernel.backward_route``'s route, the
    plain hand-derived version (``wkv6_backward_ref``) on CPU tensors.
    dr, dk, dv and dw in r's dtype, du and dstate0 float32."""
    if r.device.type == "cpu":
        return wkv6_backward_ref(r, k, v, w, u, state0, g_out, g_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_backward runs on CPU or CUDA tensors, not "
                         f"{r.device}")
    *grads, kind = wkv6_backward_cuda(
        r, k, v, w, u, state0, g_out.to(r.dtype).contiguous(),
        None if g_state is None else g_state.float().contiguous())
    wkv6_backward.launches += 1
    wkv6_backward.launches_by_route[kind] += 1
    note_cost("wkv6 backward", *wkv6_backward_cost(
        *r.shape, r.element_size(), state0 is not None,
        g_state is not None))
    return tuple(grads)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state0: (B, H, D, D) float32 or
    None (zeros).  Returns (out in r's dtype, state float32), both
    differentiable on either device."""
    if shape_only(r, k, v, w, u, state0):
        return _shape_only(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CPU or CUDA tensors, not {r.device}")
    return _WKV6.apply(r, k, v, w, u, state0)


def wkv6_cost(B: int, T: int, H: int, D: int, itemsize: int,
              with_state0: bool):
    """(flops, bytes): r, k, v, w and u read once, the state read (when
    given) and written once, the output written; 5 D^2 float32 flops per
    (batch, head, step)."""
    n = B * T * H * D
    return (5 * B * H * T * D * D,
            5 * n * itemsize + 4 * H * D
            + (2 if with_state0 else 1) * 4 * B * H * D * D)


def wkv6_backward_cost(B: int, T: int, H: int, D: int, itemsize: int,
                       with_state0: bool, with_g_state: bool):
    """(flops, bytes) the gradient needs, not the backward kernels' own
    work (which repeats some of it: ``csrc/wkv6_backward.cu`` counts it).  Flops per (batch, head, step),
    float32: 14 D^2 -- 3 D^2 to recompute S_{t-1} (diag(w) S + k^T v), 3
    D^2 for G's update (diag(w) G + r^T go), 2 D^2 each for dr (S go), dk
    (G v), dv (k G) and dw (sum_e G * S); the u terms are O(D) -- plus,
    where T spans more than one chunk of CHUNK_T steps, 3 D^2 to
    recompute the chunk entry states.  Bytes: r, k, v, w and g_out read
    and dr, dk, dv and dw written once, u read and du written, the state
    and its gradient read where given, dstate0 written."""
    n = B * T * H * D
    per_step = 14 + (3 if T > CHUNK_T else 0)
    return (per_step * B * H * T * D * D,
            9 * n * itemsize + 8 * H * D
            + (1 + with_state0 + with_g_state) * 4 * B * H * D * D)


class _ShapeOnlyWKV6(torch.autograd.Function):
    """wkv6 on local fake shards: empty outputs, the work reported.  Its
    backward reports the gradient's work (``wkv6_backward_cost``) and
    returns empty gradients."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        B, T, H, D = r.shape
        note_cost("wkv6", *wkv6_cost(B, T, H, D, r.element_size(),
                                     state0 is not None))
        ctx.shapes = [None if t is None else (t.shape, t.dtype)
                      for t in (r, k, v, w, u, state0)]
        ctx.size = (B, T, H, D, r.element_size())
        ctx.set_materialize_grads(False)
        return (r.new_empty(r.shape),
                r.new_empty((B, H, D, D), dtype=torch.float32))

    @staticmethod
    def backward(ctx, g_out, g_state):
        note_cost("wkv6 backward", *wkv6_backward_cost(
            *ctx.size, ctx.shapes[5] is not None, g_state is not None))
        like = g_out if g_out is not None else g_state
        return tuple(None if s is None else like.new_empty(s[0], dtype=s[1])
                     for s in ctx.shapes)


def _shape_only(r, k, v, w, u, state0):
    """The dry run's branch (see ``kernels.common``).  On a mesh, a mesh
    dimension that shards r's batch or heads axis shards every operand
    with it (u and the state by their heads, the state by its batch);
    any other placement is replicated first."""
    mesh = getattr(r, "device_mesh", None)
    if mesh is None:
        return _ShapeOnlyWKV6.apply(r, k, v, w, u, state0)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x_pl, u_pl, s_pl = [], [], []
    for p in r.placements:
        if isinstance(p, Shard) and p.dim in (0, 2):
            x_pl.append(p)
            u_pl.append(Shard(0) if p.dim == 2 else Replicate())
            s_pl.append(Shard(0 if p.dim == 0 else 1))
        else:
            x_pl.append(Replicate())
            u_pl.append(Replicate())
            s_pl.append(Replicate())
    out, state = _ShapeOnlyWKV6.apply(
        *(to_local(t, x_pl) for t in (r, k, v, w)), to_local(u, u_pl),
        to_local(state0, s_pl))
    B, T, H, D = r.shape
    return (DTensor.from_local(out, mesh, x_pl, run_check=False,
                               shape=r.shape, stride=r.stride()),
            DTensor.from_local(state, mesh, s_pl, run_check=False,
                               shape=(B, H, D, D),
                               stride=(H * D * D, D * D, D, 1)))


wkv6.launches = 0
wkv6.launches_by_route = dict.fromkeys(ROUTES, 0)
wkv6_backward.launches = 0
wkv6_backward.launches_by_route = dict.fromkeys(BACKWARD_ROUTES, 0)
