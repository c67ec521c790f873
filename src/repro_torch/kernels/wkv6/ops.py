"""The RWKV6 WKV recurrence: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``wkv6.launches`` counts the kernel's launches, so a run can show that
its main path went through the kernel, and ``wkv6.launches_by_route`` the
launches of each route (``kernel.route``: ``step`` or ``chunked``; the
chunked route's three kernels are one C call and count as one launch).

On the card the kernel runs inside an ``autograd.Function``: its forward
is the kernel, its backward recomputes the recurrence through the
differentiable plain version (``wkv6_ref``) and returns the gradients of
r, k, v, w, u and state0.  The reference trains through its ``lax.scan``
the same way and has no backward kernel either.  On the CPU ``wkv6_ref``
is differentiable as it stands.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import note_cost, shape_only, to_local
from .kernel import ROUTES, wkv6_cuda
from .ref import wkv6_ref


class _WKV6(torch.autograd.Function):
    """The kernel's forward and a recomputing backward (see the module
    note).  The backward holds one layer's per-step graph at a time: the
    recurrence is rebuilt for the call being differentiated only."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, state, kind = wkv6_cuda(r, k, v, w, u, state0)
        wkv6.launches += 1
        wkv6.launches_by_route[kind] += 1
        note_cost("wkv6", *wkv6_cost(*r.shape, r.element_size(),
                                     state0 is not None))
        ctx.save_for_backward(r, k, v, w, u, state0)
        return out, state

    @staticmethod
    def backward(ctx, g_out, g_state):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            out, state = wkv6_ref(*leaves)
            pairs = [(o, g) for o, g in ((out, g_out), (state, g_state))
                     if g is not None]
            wanted = [t for t, n in zip(leaves, need) if t is not None and n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True))
        return tuple(next(grads) if t is not None and n else None
                     for t, n in zip(leaves, need))


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


class _ShapeOnlyWKV6(torch.autograd.Function):
    """wkv6 on local fake shards: empty outputs, the work reported.  Its
    backward reports twice the forward's flops (the recurrence recomputed,
    then its gradient pass) over the inputs, the output gradients and the
    input gradients, and returns empty gradients."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        B, T, H, D = r.shape
        note_cost("wkv6", *wkv6_cost(B, T, H, D, r.element_size(),
                                     state0 is not None))
        ctx.shapes = [None if t is None else (t.shape, t.dtype)
                      for t in (r, k, v, w, u, state0)]
        ctx.size = (B, T, H, D, r.element_size())
        return (r.new_empty(r.shape),
                r.new_empty((B, H, D, D), dtype=torch.float32))

    @staticmethod
    def backward(ctx, g_out, g_state):
        B, T, H, D, itemsize = ctx.size
        flops, moved = wkv6_cost(B, T, H, D, itemsize, True)
        note_cost("wkv6 backward", 2 * flops,
                  moved + 5 * B * T * H * D * itemsize)
        return tuple(None if s is None else
                     g_out.new_empty(s[0], dtype=s[1])
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
