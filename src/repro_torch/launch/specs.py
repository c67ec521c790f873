"""Abstract stand-ins for every model input (PyTorch port of
``repro.launch.specs``): DTensors on the dry run's mesh whose local shards
are fake tensors of the mesh's device type, placed by the sharding rules.
They hold shapes, dtypes and placements and allocate nothing.

Call these under the dry run's ``FakeTensorMode`` (``dryrun.abstract``).
For [audio]/[vlm] archs the modality frontend is a stub: inputs are
precomputed frame/patch embeddings (B, T, d_model).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..configs.registry import ShapeCell
from ..dist.sharding import (Spec, batch_spec, cache_spec, param_specs,
                             placements)
from ..models.common import ModelConfig
from ..models.rwkv6 import RWKV6
from ..models.transformer import Transformer
from ..models.zoo import Model, Zamba2
from ..train import optimizer as optim
from ..train.step import TrainState


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device the mesh's local shards live on (this process is rank
    0 of the fake group)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, 0)


def local_shape(shape: Sequence[int], spec: Spec, mesh: DeviceMesh
                ) -> Tuple[int, ...]:
    """Rank 0's shard shape: each dimension divided by the sizes of the
    mesh axes its spec entry names (the rules shard only what divides)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for n, entry in zip(shape, spec):
        names = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        for name in names:
            n //= sizes[name]
        out.append(n)
    return tuple(out)


def _contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _sds(shape, dtype, mesh: DeviceMesh, spec: Spec) -> DTensor:
    shape = tuple(shape)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device=mesh_device(mesh))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def token_or_embed_spec(cfg: ModelConfig, B: int, T: int, mesh: DeviceMesh):
    if cfg.input_mode == "tokens":
        return _sds((B, T), torch.int32, mesh, batch_spec((B, T), mesh))
    shape = (B, T, cfg.d_model)
    return _sds(shape, cfg.dtype, mesh, batch_spec(shape, mesh))


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh: DeviceMesh):
    B, T = cell.global_batch, cell.seq_len
    return {
        "inputs": token_or_embed_spec(cfg, B, T, mesh),
        "labels": _sds((B, T), torch.int32, mesh, batch_spec((B, T), mesh)),
    }


def params_module(cfg: ModelConfig, device) -> nn.Module:
    """The parameter module of ``cfg``'s family, uninitialised on
    ``device`` (under fake mode: no storage at all)."""
    cls = {"ssm": RWKV6, "hybrid": Zamba2}.get(cfg.family, Transformer)
    return cls(cfg, None, device)


def abstract_params(model: Model, mesh: DeviceMesh,
                    dtype=None) -> Tuple[nn.Module, Dict[str, Spec]]:
    """(parameter module whose parameters are abstract DTensors, each
    parameter's spec by name); ``dtype`` overrides every parameter's."""
    params = params_module(model.cfg, torch.device("meta"))
    specs = param_specs(params, mesh)
    for name, p in list(params.named_parameters()):
        prefix, _, attr = name.rpartition(".")
        owner = params.get_submodule(prefix) if prefix else params
        owner._parameters[attr] = nn.Parameter(
            _sds(p.shape, dtype or p.dtype, mesh, specs[name]),
            requires_grad=False)
    return params, specs


def abstract_train_state(model: Model, mesh: DeviceMesh) -> TrainState:
    """Parameters with gradients on, and the optimizer's float32 master,
    m and v placed as their parameters."""
    params, specs = abstract_params(model, mesh)
    params.requires_grad_(True)

    def f32():
        return {n: _sds(p.shape, torch.float32, mesh, specs[n])
                for n, p in params.named_parameters()}

    return TrainState(params, optim.OptState(step=0, master=f32(), m=f32(),
                                             v=f32()))


def abstract_cache(model: Model, B: int, S: int, mesh: DeviceMesh) -> Any:
    """``model.init_cache(B, S)``'s structure, each tensor placed by
    :func:`cache_spec`."""
    def place(x):
        if isinstance(x, torch.Tensor):
            return _sds(x.shape, x.dtype, mesh, cache_spec(x.shape, mesh))
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        return type(x)(place(v) for v in x)

    return place(model.init_cache(B, S))


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell, mesh: DeviceMesh):
    B = cell.global_batch
    if cfg.input_mode == "tokens":
        toks = _sds((B, 1), torch.int32, mesh, batch_spec((B, 1), mesh))
    else:
        toks = _sds((B, 1, cfg.d_model), cfg.dtype, mesh,
                    batch_spec((B, 1, cfg.d_model), mesh))
    pos = _sds((B, 1), torch.int32, mesh, batch_spec((B, 1), mesh))
    lens = _sds((B,), torch.int32, mesh, batch_spec((B,), mesh))
    return toks, pos, lens
