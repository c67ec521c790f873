"""Weights from the seed, made on the device in a few large calls.

Parameters of one dtype and one distribution share one flat tensor, drawn
by a single ``normal_`` or ``uniform_`` on a ``torch.Generator`` of the
device, in the dtype they are served in; each parameter is then a view
of it, scaled in place.  The same seed gives the same tensors, so the
reference can draw them again after the program is freed.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

ALIGN = 64          # elements between views: 128-byte aligned in bf16


def draw(specs: List, seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor for every spec (``reference.plain.ParamSpec``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    groups: Dict[tuple, List] = {}
    for s in specs:
        groups.setdefault((str(s.dtype), s.init[0]), []).append(s)
    out = {}
    for (_, kind), members in sorted(groups.items()):
        sizes = [math.prod(s.shape) for s in members]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // ALIGN) * ALIGN
        flat = torch.empty(total, dtype=members[0].dtype, device=device)
        if kind == "normal":
            flat.normal_(generator=gen)
        else:
            flat.uniform_(generator=gen)
        for s, off, n in zip(members, offsets, sizes):
            t = flat[off:off + n].view(s.shape)
            if kind == "normal":
                t.mul_(s.init[1])
            else:
                t.mul_(s.init[2] - s.init[1]).add_(s.init[1])
            out[s.name] = t
    return out


def install(module: nn.Module, tensors: Dict[str, torch.Tensor]
            ) -> nn.Module:
    """Put ``tensors`` in place of ``module``'s parameters of the same
    names.  The names, shapes and dtypes must match one for one."""
    have = {n: (tuple(p.shape), p.dtype)
            for n, p in module.named_parameters()}
    want = {n: (tuple(t.shape), t.dtype) for n, t in tensors.items()}
    if have != want:
        diff = sorted(map(str, set(have.items()) ^ set(want.items())))
        raise ValueError(f"the port's parameters differ from the "
                         f"reference's specification: {diff[:8]}")
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, nn.Parameter(t, requires_grad=False))
    return module
