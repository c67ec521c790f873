"""Fault-tolerant checkpointing: async, atomic, restorable onto any
placement (PyTorch port of ``repro.checkpoint.checkpointer``).

Layout per step, the reference's own, so a checkpoint either package
writes restores in the other:
    <dir>/step_<N>.tmp/ -> atomically renamed to <dir>/step_<N>/
        manifest.json            (leaf paths + shapes + dtypes + step)
        shard_0.npz              (leaf_<i>: the i-th leaf, whole)

Leaves are written in the reference's pytree order and spelling
(``jax.tree_util.keystr``): NamedTuple fields in order (``.params``,
``.opt.master``), dict keys sorted (``['dense_layers']['attn']['wq']``),
sequence items by index.  The port's trees differ from the reference's in
two places, and both are written in the reference's layout:

  * parameters live in an ``nn.Module`` and the optimizer's master / m / v
    in dicts keyed by parameter name; a per-layer parameter
    (``dense_layers.3.attn.wq``) is one slice of the reference's stacked
    leaf ``['dense_layers']['attn']['wq']`` (the inverse of
    ``repro_torch.convert.params_from_jax``);
  * counters held as Python ints (``OptState.step``) are written as 0-d
    int32, as the reference's step is.

bfloat16 leaves are written as the reference writes them: 2-byte ``|V2``
words (numpy has no bfloat16), read back as bfloat16 with the same bits.

  * async: ``save`` copies every tensor to host memory synchronously
    (a copy even of a CPU tensor) and writes on a background thread;
  * atomic: tmp-dir + rename, so a failure mid-write never corrupts the
    latest checkpoint;
  * placement on restore: ``sharding_fn(path, shape)`` may put each leaf
    on a device or shard it over a ``DeviceMesh`` (the counterpart of
    ``jax.make_array_from_callback``);
  * keep-k GC.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch
from torch import nn

_V2 = np.dtype("V2")


class _Stack:
    """The per-layer tensors that make up one stacked leaf, in layer
    order."""

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = parts


def _is_named(tree: Any) -> bool:
    """A dict keyed by parameter names (an optimizer's master / m / v)."""
    return isinstance(tree, Mapping) and any(
        isinstance(k, str) and "." in k for k in tree)


def _split(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``dense_layers.3.attn.wq`` -> (('dense_layers', 'attn', 'wq'), 3)."""
    parts = name.split(".")
    index = [int(k) for k in parts if k.isdigit()]
    if len(index) > 1:
        raise ValueError(f"{name}: more than one layer index")
    return (tuple(k for k in parts if not k.isdigit()),
            index[0] if index else None)


def _keystr(keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _grouped(named: Mapping[str, Any]) -> Dict[Tuple[str, ...], Any]:
    """Names grouped into the reference's leaves: key path -> the tensor,
    or a _Stack of the per-layer tensors."""
    groups: Dict[Tuple[str, ...], Dict[Optional[int], Any]] = {}
    for name, t in named.items():
        keys, i = _split(name)
        groups.setdefault(keys, {})[i] = t
    out = {}
    for keys, by_index in groups.items():
        if None in by_index:
            out[keys] = by_index[None]
        else:
            out[keys] = _Stack([by_index[i] for i in range(len(by_index))])
    return out


def _flatten(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in the reference's ``tree_flatten`` order; a
    leaf is a tensor, an array, a number or a _Stack."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if _is_named(tree):
        groups = _grouped(tree)
        for keys in sorted(groups):
            yield path + _keystr(keys), groups[keys]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _flatten(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host(leaf: Any) -> Any:
    """A host snapshot of one leaf: a CPU tensor or a numpy array that
    shares no storage with the live leaf (``.cpu()`` of a CPU tensor is
    the tensor itself, which the next step would update under the
    writer)."""
    if isinstance(leaf, _Stack):
        return torch.stack([_whole(t) for t in leaf.parts]).cpu()
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).to("cpu", copy=True)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor detached, and a DTensor's whole value."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach()


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """(array as written, manifest dtype)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(_V2), \
                "bfloat16"
        x = x.numpy()
    return x, str(x.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _drop_layer_axis(spec: Any) -> Any:
    """A stacked leaf's placement for one of its layers: a device as it
    is; a mesh's placements with the layer axis dropped (a layer axis
    sharded on a mesh dimension becomes replicated there)."""
    if not isinstance(spec, tuple):
        return spec
    from torch.distributed.tensor import Replicate, Shard
    mesh, placements = spec
    out = []
    for p in placements:
        if isinstance(p, Shard):
            p = Replicate() if p.dim == 0 else Shard(p.dim - 1)
        out.append(p)
    return mesh, out


def _place(value: torch.Tensor, spec: Any, like: torch.Tensor
           ) -> torch.Tensor:
    """``value`` (a host tensor) into ``like``'s place: copied into
    ``like`` when ``spec`` is None, else a new tensor of ``like``'s dtype
    on the device ``spec`` names or sharded over its (mesh, placements)."""
    if spec is None:
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(f"shape {tuple(value.shape)} != "
                             f"{tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(value)
        return like
    if isinstance(spec, tuple):
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = spec
        value = value.to(device=mesh.device_type, dtype=like.dtype)
        return distribute_tensor(value, mesh, list(placements),
                                 src_data_rank=None)
    return value.to(device=spec, dtype=like.dtype)


def _param_owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, attr = name.rpartition(".")
    return (module.get_submodule(prefix) if prefix else module), attr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        # synchronous device->host snapshot (consistency point)
        leaves = [(p, _host(leaf)) for p, leaf in _flatten(tree)]

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            arrays = [(p, *_to_numpy(x)) for p, x in leaves]
            manifest = {
                "step": step,
                "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt}
                           for p, a, dt in arrays],
            }
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, (_p, a, _dt)
                        in enumerate(arrays)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def write_in_background():
            try:
                write()
            except BaseException as e:  # noqa: BLE001 -- raised by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_in_background,
                                            daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Joins the background write; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                sharding_fn: Optional[Callable] = None) -> Any:
        """Restore into the structure of ``like`` and return it: tensors
        (a module's parameters included) are written in place; numbers
        come back as Python numbers.  If ``sharding_fn(leaf_path, shape)``
        returns a device or a ``(DeviceMesh, placements)`` pair, each
        tensor is made anew there instead (a module's parameter is
        replaced); a per-layer parameter takes its stacked leaf's
        placement with the layer axis dropped."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "shard_0.npz"))
        by_path = {l["path"]: _from_numpy(data[f"leaf_{i}"], l["dtype"])
                   for i, l in enumerate(manifest["leaves"])}
        n_like = sum(1 for _ in _flatten(like))
        if n_like != len(by_path):
            raise ValueError(f"leaf count mismatch {n_like} != "
                             f"{len(by_path)}")

        def spec_of(path: str):
            if sharding_fn is None:
                return None
            return sharding_fn(path, tuple(by_path[path].shape))

        def named(tensors: Mapping[str, torch.Tensor], path: str,
                  put: Callable[[str, torch.Tensor], None]) -> None:
            for name, t in tensors.items():
                keys, i = _split(name)
                leaf = path + _keystr(keys)
                value, spec = by_path[leaf], spec_of(leaf)
                if i is not None:
                    value, spec = value[i], _drop_layer_axis(spec)
                put(name, _place(value, spec, t))

        def rebuild(tree: Any, path: str) -> Any:
            if isinstance(tree, nn.Module):
                def put(name, new):
                    owner, attr = _param_owner(tree, name)
                    old = owner._parameters[attr]
                    if new is not old:
                        owner._parameters[attr] = nn.Parameter(
                            new, requires_grad=old.requires_grad)
                named(dict(tree.named_parameters()), path, put)
                return tree
            if _is_named(tree):
                out: Dict[str, torch.Tensor] = {}
                named(tree, path, out.__setitem__)
                return {k: out[k] for k in tree}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*(rebuild(getattr(tree, f), f"{path}.{f}")
                                    for f in tree._fields))
            if isinstance(tree, Mapping):
                return {k: rebuild(v, f"{path}[{k!r}]")
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(rebuild(v, f"{path}[{i}]")
                                  for i, v in enumerate(tree))
            if tree is None:
                return None
            value = by_path[path]
            if isinstance(tree, torch.Tensor):
                return _place(value, spec_of(path), tree)
            if isinstance(tree, bool):
                return bool(value)
            if isinstance(tree, int):
                return int(value)
            if isinstance(tree, float):
                return float(value)
            return value.numpy()

        return rebuild(like, "")
