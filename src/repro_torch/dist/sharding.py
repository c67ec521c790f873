"""Sharding rules: shape -> partition spec for params, batches and caches
(PyTorch port of ``repro.dist.sharding``).

One policy, applied everywhere (``launch/specs.py`` builds every dry-run
input through these):

  * model parallelism ("model" axis) goes to the feature-like dimension
    -- the last axis of a weight matrix, the expert axis of a MoE stack,
    the kv-heads axis of a cache (falling back to the sequence axis for
    MQA, where kv-heads is indivisible);
  * data parallelism ("data", composed with "pod" on multi-pod meshes)
    goes to the leading batch-like dimension;
  * an axis is only sharded when the mesh axis size divides it exactly --
    anything indivisible is replicated, never padded.

A spec is a plain tuple with one entry per tensor dimension: None, a
mesh axis name, or a tuple of names (major to minor), equal entry for
entry to the reference's ``PartitionSpec``.  :func:`tree_shardings`
turns specs into DTensor placements on a ``DeviceMesh``.

``params_shardings`` reads the reference's parameter layout, in which
each group of layers is stacked on a leading axis (:func:`stacked_shapes`
gives that tree for the port's parameter module), and gives the
reference's specs exactly.  That includes its reading of "moe" in a path
as "this leaf has an expert axis": on every ``moe_layers`` leaf the
*layer* axis takes the expert rule (ROADMAP C12).  A per-layer parameter
of the port is placed by its stacked leaf's spec with the layer axis
dropped (:func:`param_placements`), so where the reference shards the
layer axis the port replicates across that mesh axis.

The functions accept a ``DeviceMesh`` or any object with ``devices``
(ndarray) and ``axis_names``, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

AxisEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisEntry, ...]


def _axis_sizes(mesh: Any) -> dict:
    if hasattr(mesh, "mesh_dim_names"):                 # a DeviceMesh
        return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))
    return dict(zip(tuple(mesh.axis_names), mesh.devices.shape))


def _data_axis(mesh: Any, dim: int) -> AxisEntry:
    """The largest data-parallel axis (combo) that divides ``dim``:
    ("pod", "data") on multi-pod meshes, then "data", then "pod"."""
    sizes = _axis_sizes(mesh)
    candidates = []
    if "pod" in sizes and "data" in sizes:
        candidates.append((("pod", "data"), sizes["pod"] * sizes["data"]))
    if "data" in sizes:
        candidates.append(("data", sizes["data"]))
    if "pod" in sizes:
        candidates.append(("pod", sizes["pod"]))
    for axis, n in candidates:
        if n > 1 and dim % n == 0:
            return axis
    return None


def param_spec(shape: Sequence[int], mesh: Any, stacked: bool = False,
               expert: bool = False) -> Spec:
    """Spec for one parameter tensor.

    stacked: leading axis is a scanned layer stack -- never sharded.
    expert:  leading (post-stack) axis enumerates MoE experts -- expert
             parallelism maps it onto the "model" axis.
    """
    shape = tuple(shape)
    sizes = _axis_sizes(mesh)
    mp = sizes.get("model", 1)
    spec: list = [None] * len(shape)
    dims = list(range(len(shape)))
    if stacked and dims:
        dims = dims[1:]

    model_used = False
    if expert and dims:
        d = dims[0]
        if mp > 1 and shape[d] % mp == 0:
            spec[d] = "model"
            model_used = True
        dims = dims[1:]
    if not model_used and dims and mp > 1 and shape[dims[-1]] % mp == 0:
        spec[dims[-1]] = "model"
        model_used = True
        dims = dims[:-1]

    for d in dims:  # FSDP-style: first remaining dim the dp size divides
        axis = _data_axis(mesh, shape[d])
        if axis is not None:
            spec[d] = axis
            break
    return tuple(spec)


def batch_spec(shape: Sequence[int], mesh: Any) -> Spec:
    """Spec for an activation/batch tensor: leading dim across the
    data-parallel axes when divisible, everything else replicated."""
    shape = tuple(shape)
    spec: list = [None] * len(shape)
    if shape:
        spec[0] = _data_axis(mesh, shape[0])
    return tuple(spec)


def cache_spec(shape: Sequence[int], mesh: Any) -> Spec:
    """Spec for a KV/state cache laid out ``(..., batch, heads, seq,
    head_dim)`` (a leading stacked-layers axis is fine).

    Heads shard on "model"; with indivisible heads (MQA/GQA down to
    kv=1) the sequence axis takes "model" instead.  The batch axis shards
    on data.
    """
    shape = tuple(shape)
    r = len(shape)
    spec: list = [None] * r
    sizes = _axis_sizes(mesh)
    mp = sizes.get("model", 1)
    if mp > 1:
        for d in (r - 3, r - 2):  # heads first, then sequence
            if 0 <= d and shape[d] % mp == 0:
                spec[d] = "model"
                break
    b = r - 4 if r >= 4 else 0
    if 0 <= b < r and spec[b] is None:
        spec[b] = _data_axis(mesh, shape[b])
    return tuple(spec)


def _is_shape(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def params_shardings(tree: Any, mesh: Any) -> Any:
    """Tree of specs for a parameter tree in the reference's layout (dicts
    of leaves that are shapes or have ``.shape``).  Stacked-layer and
    expert axes are recognized from the leaf's key path (scan stacks live
    under layers/blocks/stack keys; expert tensors under experts/moe
    keys) plus rank, as the reference recognizes them."""
    def spec_for(path, leaf) -> Spec:
        name = "/".join(path).lower()
        shape = tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)
        expert = ("expert" in name or "moe" in name) and len(shape) >= 2
        stacked = (len(shape) >= 3 and not expert
                   and any(t in name for t in ("layers", "blocks", "stack")))
        return param_spec(shape, mesh, stacked=stacked, expert=expert)
    return _map_with_path(spec_for, tree)


def placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements on ``mesh`` (a DeviceMesh) for ``spec``: per mesh
    dimension, ``Shard(d)`` for the tensor dimension whose entry names it
    (a tuple entry shards one dimension over several mesh dimensions,
    major to minor), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def tree_shardings(tree: Any, mesh: Any, specs: Optional[Any] = None
                   ) -> Any:
    """Tree of ``(mesh, placements)`` for ``tree`` on ``mesh`` (a
    DeviceMesh) -- ``specs`` overrides the per-leaf specs (defaults to
    :func:`params_shardings`).  A pair is what
    ``Checkpointer.restore``'s ``sharding_fn`` may return."""
    if specs is None:
        specs = params_shardings(tree, mesh)
    return _map_with_path(lambda _p, s: (mesh, placements(s, mesh)), specs)


# ----------------------------------------- the port's parameter modules
def stacked_shapes(params: Any) -> Dict[str, Any]:
    """The reference's parameter tree of shapes for a port parameter
    module: ``dense_layers.3.attn.wq`` of shape (d, h) is one layer of the
    leaf ``['dense_layers']['attn']['wq']`` of shape (n_dense, d, h)."""
    groups: Dict[Tuple[str, ...], Dict[Optional[int], Tuple[int, ...]]] = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        keys = tuple(k for k in parts if not k.isdigit())
        index = [int(k) for k in parts if k.isdigit()]
        groups.setdefault(keys, {})[index[0] if index else None] = \
            tuple(p.shape)
    tree: Dict[str, Any] = {}
    for keys, by_index in groups.items():
        shape = by_index.get(None)
        if shape is None:
            shape = (len(by_index),) + by_index[0]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = shape
    return tree


def param_specs(params: Any, mesh: Any) -> Dict[str, Spec]:
    """Each parameter's spec by name: its stacked leaf's spec, with the
    layer axis dropped for a per-layer parameter."""
    specs = params_shardings(stacked_shapes(params), mesh)
    out = {}
    for name, _p in params.named_parameters():
        parts = name.split(".")
        node = specs
        for k in (k for k in parts if not k.isdigit()):
            node = node[k]
        out[name] = node[1:] if any(k.isdigit() for k in parts) else node
    return out


def param_placements(params: Any, mesh: Any) -> Dict[str, list]:
    """Each parameter's DTensor placements on ``mesh`` by name (see
    :func:`param_specs`)."""
    return {n: placements(s, mesh)
            for n, s in param_specs(params, mesh).items()}
