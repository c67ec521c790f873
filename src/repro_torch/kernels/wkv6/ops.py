"""The RWKV6 WKV recurrence: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``wkv6.launches`` counts the kernel's launches, so a run can show that
its main path went through the kernel, and ``wkv6.launches_by_route`` the
launches of each route (``kernel.route``: ``step`` or ``chunked``; the
chunked route's three kernels are one C call and count as one launch).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import ROUTES, wkv6_cuda
from .ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state0: (B, H, D, D) float32 or
    None (zeros).  Returns (out in r's dtype, state float32)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CPU or CUDA tensors, not {r.device}")
    out, state, kind = wkv6_cuda(r, k, v, w, u, state0)
    wkv6.launches += 1
    wkv6.launches_by_route[kind] += 1
    return out, state


wkv6.launches = 0
wkv6.launches_by_route = dict.fromkeys(ROUTES, 0)
