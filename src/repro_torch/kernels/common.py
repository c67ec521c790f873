"""Shared helpers for the port's kernel wrappers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_on_card(named) -> None:
    """Every (name, tensor) lies on the first one's CUDA device and is
    contiguous, as a kernel that reads raw pointers needs."""
    device = named[0][1].device
    for name, t in named:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be "
                             f"on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pad_to(x: torch.Tensor, axis: int, multiple: int):
    """Zero-pad ``axis`` up to a multiple; returns (padded, original_size)."""
    size = x.shape[axis]
    target = cdiv(size, multiple) * multiple
    if target == size:
        return x, size
    axis = axis % x.ndim
    # F.pad lists (before, after) pairs from the last axis backwards
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, target - size]
    return F.pad(x, pad), size
