"""Shared helpers for the port's kernel wrappers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
