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
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CPU or CUDA tensors, not {r.device}")
    return _WKV6.apply(r, k, v, w, u, state0)


wkv6.launches = 0
wkv6.launches_by_route = dict.fromkeys(ROUTES, 0)
