"""Shared helpers for the port's kernel wrappers."""
from __future__ import annotations

import contextlib

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


# ---------------------------------------------------- shape-only tracing
# The launch dry run traces the port's programs on fake tensors (no data,
# no card).  A kernel wrapper handed such tensors takes its shape-only
# branch: it returns empty outputs of the kernel's shapes and dtypes, does
# no arithmetic and launches nothing (its launch counters stay as they
# are).  On either branch a wrapper reports the call's work by the
# kernel's formula to every cost sink registered here
# (``repro_torch.roofline.hlo.TraceCounter``), which cannot see inside a
# launch.  The shape-only branch never runs on real tensors.
COST_SINKS: list = []
_REPEAT = [1]


@contextlib.contextmanager
def repeated(n: int):
    """Work counted inside stands for ``n`` identical repetitions: a
    program that repeats one step with the same shapes traces it once
    (see ``models.mamba2._ssd_scan``)."""
    _REPEAT.append(_REPEAT[-1] * n)
    try:
        yield
    finally:
        _REPEAT.pop()


def repeat_factor() -> int:
    return _REPEAT[-1]


def shape_only(*tensors) -> bool:
    """True when every tensor given is a fake tensor, or a DTensor whose
    local shard is one.  (Meta tensors are refused as any other device
    is: the dry run's tensors are fake ones of the card's device type.)"""
    from torch._subclasses.fake_tensor import is_fake
    ts = [t for t in tensors if isinstance(t, torch.Tensor)]
    return bool(ts) and all(is_fake(t) for t in ts)


def note_cost(name: str, flops: float, nbytes: float,
              transcendentals: float = 0.0) -> None:
    """Reports one shape-only kernel call's work (per device: the local
    shards' shapes) to the registered sinks."""
    for sink in COST_SINKS:
        sink(name, float(flops), float(nbytes), float(transcendentals))


def to_local(t, placements):
    """A DTensor redistributed to ``placements`` and its local shard (any
    other tensor as it is); differentiable."""
    if t is None or not hasattr(t, "device_mesh"):
        return t
    return t.redistribute(t.device_mesh, placements).to_local()


def replicated_locals(*tensors):
    """Each DTensor replicated on every mesh dimension, as its local
    tensor; other tensors as they are."""
    from torch.distributed.tensor import Replicate
    return tuple(
        to_local(t, [Replicate()] * t.device_mesh.ndim)
        if hasattr(t, "device_mesh") else t for t in tensors)
