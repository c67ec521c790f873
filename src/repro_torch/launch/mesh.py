"""Production mesh construction (PyTorch port of ``repro.launch.mesh``).

The dry run needs a 256- or 512-device mesh on one host with no such
cluster.  ``torch.distributed``'s fake backend gives it: a process group of
any size whose collectives return at once (their outputs are only shaped,
never filled), so DTensor programs trace on the production mesh with one
process.  These are FUNCTIONS (not module-level meshes) so importing never
touches process-group state.

One process holds one default process group: asking for a mesh of another
size tears the current fake group down and starts one of that size.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


def _fake_world(size: int) -> None:
    """A fake default process group of ``size`` ranks, this process rank
    0; an existing one of another size (or backend) is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def release() -> None:
    """Destroys the fake process group the meshes run on, if any."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def fake_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None) -> DeviceMesh:
    """A ``shape`` mesh with ``axes`` names over a fake process group of
    that many ranks, of ``device``'s type (default the card's)."""
    n = 1
    for s in shape:
        n *= s
    _fake_world(n)
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...],
                                                Tuple[str, ...]]:
    """Single pod: 16x16 = 256 devices (data, model).  Multi-pod: 2 pods x
    256 = 512 devices (pod, data, model) -- the "pod" axis composes with
    "data" for cross-pod FSDP/DP."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    return fake_mesh(*production_shape(multi_pod), device=device)


def make_smoke_mesh(device: DeviceLike = None) -> DeviceMesh:
    """1-device mesh with production axis names (CI smoke tests)."""
    return fake_mesh((1, 1), ("data", "model"), device=device)
