"""What DTensor needs to trace the port's programs in the launch dry run.

:func:`install` (the dry run, and the cost counter once it meets a
DTensor, call it; nothing outside a DTensor program is affected):

  * a sharding rule for ``aten.index_put`` where DTensor has none
    (below);
  * a sharding rule for ``aten.gather``: cross-entropy gathers the gold
    logit along the vocab axis.  DTensor's own rule keeps a vocab-sharded
    input sharded and masks the result, which then fails to reduce for a
    gather's output shape.  This rule shards input, index and output
    alike on any other dimension and replicates the gathered one (GSPMD
    does the same for the reference's ``take_along_axis``);
  * DTensor's strided-shard bookkeeping and its output-shape propagation
    kept out of the dry run's fake mode and counters (below).

:class:`ModelGaps`, a function mode the dry run enters around each
trace, gives six of the models' plain-tensor idioms a DTensor form, and
works around the ops some torch versions' DTensor refuses (below), so the
models keep one path.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.overrides import TorchFunctionMode


def _gather(x, dim, index, sparse_grad=False):
    dim = dim % x.ndim
    out = [([Replicate()], [Replicate(), None, Replicate()])]
    for d in range(x.ndim):
        if d != dim:
            out.append(([Shard(d)], [Shard(d), None, Shard(d)]))
    return out


def _index_put(self, indices, values, accumulate=False):
    """``self[indices] = values`` (MoE dispatching tokens into its zero
    buffer).  torch 2.11's DTensor has no rule for it.  Everything
    replicated; or, where the index tensors take the leading dimensions,
    ``self`` and ``values`` sharded alike on a trailing one."""
    n = len(indices)
    out = [([Replicate()], [Replicate()] * (n + 2) + [None])]
    if all(i is not None for i in indices):
        lead = max(i.ndim for i in indices)
        for d in range(n, self.ndim):
            out.append(([Shard(d)], [Shard(d)] + [Replicate()] * n
                        + [Shard(d - n + lead), None]))
    return out


# DTensor computes a strided shard's local size and offsets (the layout a
# reshape gives when it merges two sharded dimensions, as attention's
# einsums do) by splitting a real index range: torch.arange over the
# dimension, one chunk per piece of the split factor, then .tolist().
# Under the dry run's FakeTensorMode those ops are faked -- .tolist() on a
# fake range fails or makes one unbacked symbol per element -- the dry
# run's counters would count them as program work, and with a split factor
# in the thousands (a 32k sequence merged with a sharded batch) the
# Python loop over pieces takes minutes a call.  The same size and offsets
# follow from the chunk arithmetic alone (``strided_size_and_offset``,
# held to DTensor's own by tests/test_torch_launch.py).
#
# DTensor's output-shape propagation runs each op once on fake tensors of
# the *global* shapes, under whatever fake mode is current: the dry run's
# cost counter and memory tracker would see global-size work and
# allocations no device does.  It runs with the dry run's modes set aside,
# under a fake mode of its own.
def strided_size_and_offset(self, curr_local_size, num_chunks, rank,
                            mode=True, **kwargs):
    """``_StridedShard.local_shard_size_and_offset`` by arithmetic: rank
    ``rank``'s part of a dimension of ``curr_local_size`` split first into
    ``split_factor`` pieces, each piece into ``num_chunks`` chunks
    (``torch.chunk``'s sizes); its size, and its offsets as ``mode`` asks:
    the first (-1 if empty), all of them, or none (``mode`` is torch
    2.11's ``return_first_offset`` bool or later versions' FIRST / ALL /
    NONE enum)."""
    mode = kwargs.get("offset_mode", kwargs.get("return_first_offset", mode))
    n, factor = int(curr_local_size), int(self.split_factor)
    chunks, rank = int(num_chunks), int(rank)
    if isinstance(mode, bool):
        want = "first" if mode else "all"
    else:
        want = ("first", "all", "none")[int(mode)]
    piece = -(-n // factor)
    size, runs = 0, []
    for j in range(factor):
        start = min(piece * j, n)
        length = min(piece * (j + 1), n) - start
        part = -(-length // chunks)
        lo, hi = min(part * rank, length), min(part * (rank + 1), length)
        if hi > lo:
            size += hi - lo
            runs.append((start + lo, start + hi))
    if want == "none":
        return size, None
    if want == "first":
        return size, runs[0][0] if runs else -1
    return size, [i for lo, hi in runs for i in range(lo, hi)]


def _outside_modes(fn):
    import functools

    from torch.utils._python_dispatch import _disable_current_modes

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    wrapper._outside_modes = True
    return wrapper


def _wrap(cls, name: str) -> None:
    attr = cls.__dict__.get(name)
    if isinstance(attr, (staticmethod, classmethod)):
        if not getattr(attr.__func__, "_outside_modes", False):
            setattr(cls, name, type(attr)(_outside_modes(attr.__func__)))
    elif callable(attr) and not getattr(attr, "_outside_modes", False) \
            and not hasattr(attr, "cache_info"):
        setattr(cls, name, _outside_modes(attr))


_DTENSOR_STRIDED_SIZE = None     # DTensor's own version, kept for tests


def _patch_strided_shard() -> None:
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    global _DTENSOR_STRIDED_SIZE
    own = None if cls is None else cls.__dict__.get(
        "local_shard_size_and_offset")
    if own is not None and own is not strided_size_and_offset:
        _DTENSOR_STRIDED_SIZE = own
        cls.local_shard_size_and_offset = strided_size_and_offset


def _patch_meta_propagation() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        _wrap(ShardingPropagator, name)


def _has_strategy(prop, op) -> bool:
    """Whether DTensor has a rule of its own for ``op`` (a later torch's
    single-dim strategies take precedence over a registered one)."""
    return any(op in getattr(prop, table, {}) for table in (
        "op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"))


_installed = False


def install() -> None:
    """Registers the rules and the two patches, once a process."""
    global _installed
    if _installed:
        return
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(torch.ops.aten.gather.default)(_gather)
    prop = DTensor._op_dispatcher.sharding_propagator
    for op in (torch.ops.aten.index_put_.default,
               torch.ops.aten.index_put.default):
        if not _has_strategy(prop, op):
            register_sharding(op)(_index_put)
    _patch_strided_shard()
    _patch_meta_propagation()
    _installed = True


# ------------------------------------------------- the models' DTensor gaps
# The models index, write, reshape and contract as plain tensors do.  Six
# of those idioms have no DTensor rule that holds on every torch version,
# and the layout each takes here follows from what the model means, which
# an op's sharding rule cannot see:
#
#   * ``table[ids]`` on a 2-D table (an embedding lookup).  DTensor's
#     vocab-parallel lookup and the gradient of indexing (an accumulating
#     ``index_put``) fail on some versions.  The table is gathered whole
#     along the vocabulary, as FSDP gathers a weight before its use, and
#     looked up by ``F.embedding``;
#   * ``stack[i] = value`` (a state written back into its layer stack).
#     An in-place copy may not change a placement, so ``value`` takes the
#     layer's placements first;
#   * ``cache[rows, ..., positions] = values`` (decode writing K/V at each
#     row's positions).  No rule for an indexed write keeps a sharded
#     position axis in place.  Each device writes its own part: the
#     positions shifted by its shard's offset, those outside the shard
#     writing back what is there.  ``rows`` is taken to be each row's own
#     index (``arange(B)``), as every model writes it, and each row must
#     write distinct positions, as decode's one token a row does;
#   * ``t.reshape(...)`` that splits a dimension sharded over more devices
#     than the split's leading factor divides (heads from a sharded
#     projection at MQA / GQA, or tokens back into (B, T) after MoE):
#     the mesh dimensions past those the factor divides are replicated
#     first;
#   * ``torch.einsum`` where DTensor would gather a sharded operand chunk
#     by chunk, or refuses (``einsum`` below): on the local shards;
#   * ``x @ w`` in training, with the weight sharded on a mesh dimension
#     that also shards the batch (FSDP).  DTensor picks the cheaper move,
#     and where the activation is the smaller (a microbatch, one row a
#     device) it moves the activation, so every device of the data axis
#     repeats the product.  The weight is gathered there first, as FSDP
#     does.  Serving, which trains nothing, keeps DTensor's choice.
#
# Where a torch version's DTensor refuses an op for want of a layout
# (below: a merged sharded dimension, a shard made partial), the operands
# are brought to one it takes first.  The mode acts only where a DTensor
# takes part; all else passes as it is.
class ModelGaps(TorchFunctionMode):
    """Entered around a DTensor trace of the models (see above)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            table, index = args
            if _is_dt(table) and table.ndim == 2 and _is_ids(index):
                return embedding(table, index)
        elif func is torch.Tensor.__setitem__:
            dst, index, value = args
            if _is_dt(dst) and isinstance(index, int):
                return write_layer(dst, index, value)
            if _is_dt(dst) and _is_position_index(index):
                return write_positions(dst, index[-1], value,
                                       dim=len(index) - 1)
        elif func is torch.Tensor.reshape and _is_dt(args[0]):
            shape = args[1] if len(args) == 2 and \
                isinstance(args[1], (tuple, list)) else args[1:]
            return reshape(args[0], shape)
        elif func is torch.einsum and any(_is_dt(a) for a in args[1:]):
            return einsum(args[0], *args[1:])
        elif func in (torch.Tensor.matmul, torch.matmul) \
                and len(args) == 2 and all(_is_dt(a) for a in args):
            return matmul(*args)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if not _refuses_partial(e):
                raise
        return func(*_reduced(args), **_reduced(kwargs))


def _is_dt(t: Any) -> bool:
    return isinstance(t, DTensor)


def _is_ids(index: Any) -> bool:
    return isinstance(index, torch.Tensor) and not index.is_floating_point() \
        and index.dtype != torch.bool


def _is_position_index(index: Any) -> bool:
    """``(rows, :, ..., :, positions)``: two (B, T) integer tensors around
    full slices."""
    return (isinstance(index, tuple) and len(index) >= 2
            and _is_ids(index[0]) and _is_ids(index[-1])
            and index[0].ndim == 2 and index[-1].ndim == 2
            and all(i == slice(None) for i in index[1:-1]))


def embedding(table: DTensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the table gathered whole along its rows first."""
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
             for p in table.placements]
    return F.embedding(ids, table.redistribute(table.device_mesh, whole))


def write_layer(stack: DTensor, i: int, value: torch.Tensor) -> None:
    """``stack[i] = value`` with ``value`` in the layer's placements."""
    layer = stack[i]
    if _is_dt(value):
        value = value.redistribute(layer.device_mesh, layer.placements)
    layer.copy_(value)


def matmul(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w``; where ``w`` is a trained weight (2-D, requiring grad)
    sharded on a mesh dimension that also shards ``x``'s batch (its dim
    0), ``w`` is gathered there first, as FSDP gathers a weight before
    its use."""
    if x.ndim < 2 or w.ndim != 2 or not w.requires_grad:
        return x @ w
    whole = [Replicate() if isinstance(q, Shard) and p == Shard(0) else q
             for p, q in zip(x.placements, w.placements)]
    if whole != list(w.placements):
        w = w.redistribute(w.device_mesh, whole)
    return x @ w


def write_positions(cache: DTensor, positions: torch.Tensor,
                    values: torch.Tensor, dim: int) -> None:
    """``cache[b, ..., positions[b, t], ...] = values[b, t, ...]`` with the
    position axis at ``dim``, each device writing its own shard."""
    mesh, cache_pl = cache.device_mesh, list(cache.placements)
    val_pl, pos_pl = [], []
    for p in cache_pl:
        val_pl.append(p if isinstance(p, Shard) and p.dim != dim
                      else Replicate())
        pos_pl.append(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate())
    local = cache.to_local()
    vals = values.movedim(1, dim).redistribute(mesh, val_pl).to_local()
    pos = positions.redistribute(mesh, pos_pl).to_local().long()
    size, offset = cache.shape[dim], 0     # even shards, mesh dims in order
    for p, coord, n in zip(cache_pl, mesh.get_coordinate(), mesh.shape):
        if isinstance(p, Shard) and p.dim == dim:
            size //= n
            offset += coord * size
    pos = pos - offset
    inside = (pos >= 0) & (pos < local.shape[dim])
    shape = [1] * local.ndim
    shape[0], shape[dim] = pos.shape
    index = pos.clamp(0, local.shape[dim] - 1).view(shape).expand(vals.shape)
    keep = local.gather(dim, index)
    local.scatter_(dim, index, torch.where(inside.view(shape), vals, keep))


def einsum(equation: str, *operands):
    """``torch.einsum`` with a DTensor operand: on the local shards
    (``einsum_on_shards``) where a mesh dimension holds a partial operand
    that lacks the letter another operand is sharded on there (DTensor
    then gathers the sharded operand, at MQA's G 48 chunk by chunk), or
    where DTensor refuses the einsum's flattening of a sharded dimension
    (torch 2.11); else DTensor's own einsum."""
    specs = equation.replace(" ", "").partition("->")[0].split(",")
    dts = [(s, a.placements) for s, a in zip(specs, operands) if _is_dt(a)]
    for m in range(len(dts[0][1])):
        sharded = {s[p[m].dim] for s, p in dts if type(p[m]) is Shard}
        if any(p[m].is_partial() and not sharded <= set(s)
               for s, p in dts):
            out = einsum_on_shards(equation, *operands)
            if out is not None:
                return out
            break
    try:
        return torch.einsum(equation, *operands)
    except RuntimeError as e:
        if not _refuses_flatten(e):
            raise
    out = einsum_on_shards(equation, *operands)
    if out is None:
        raise RuntimeError(f"einsum {equation}: no local form for "
                           f"{[p for _, p in dts]}")
    return out


def einsum_on_shards(equation: str, *operands):
    """``torch.einsum(equation, *operands)`` computed on the local shards,
    or None for a placement other than shard, replicate or a partial sum.
    On each mesh dimension: the letter the largest operand sharded there
    is sharded on shards every operand that has it (a replicated one is
    sliced, one sharded on another letter regathered, a partial one
    reduce-scattered) and the others are replicated; the output is sharded
    on the letter, or partial where the letter is summed over.  With no
    shard the largest partial operand stays partial, and so does the
    output (an einsum is linear in each operand), the others being
    reduced."""
    lhs, _, out = equation.replace(" ", "").partition("->")
    specs = lhs.split(",")
    if not out or "." in equation or len(specs) != len(operands):
        return None
    mesh = next(a.device_mesh for a in operands if _is_dt(a))
    ops = [a if _is_dt(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for a in operands]
    by_size = sorted(range(len(ops)), key=lambda i: -ops[i].numel())
    want = [list(a.placements) for a in ops]
    out_pl = []
    for m in range(mesh.ndim):
        pls = [a.placements[m] for a in ops]
        if any(not (type(p) is Shard or p.is_replicate() or (
                p.is_partial() and p.reduce_op in ("sum", "avg")))
               for p in pls):
            return None
        sharded = [i for i in by_size if type(pls[i]) is Shard]
        partial = [i for i in by_size if pls[i].is_partial()]
        if sharded:
            letter = specs[sharded[0]][pls[sharded[0]].dim]
            for i, s in enumerate(specs):
                want[i][m] = Shard(s.index(letter)) if letter in s else \
                    Replicate()
            out_pl.append(Shard(out.index(letter)) if letter in out
                          else Partial())
        elif partial:
            for i in partial[1:]:
                want[i][m] = Replicate()
            out_pl.append(pls[partial[0]])
        else:
            out_pl.append(Replicate())
    sizes = {c: n for s, a in zip(specs, ops) for c, n in zip(s, a.shape)}
    local = torch.einsum(equation, *(
        (a.redistribute(mesh, pl) if list(a.placements) != pl else a)
        .to_local() for a, pl in zip(ops, want)))
    shape = torch.Size(sizes[c] for c in out)
    order = sorted(range(local.ndim), key=lambda d: -local.stride(d))
    stride, step = [0] * local.ndim, 1
    for d in reversed(order):
        stride[d], step = step, step * shape[d]
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=tuple(stride))


# torch 2.11's DTensor refuses two things later versions do: a view that
# merges dimensions where one past the first is sharded ("Attempted to
# flatten multiple dimensions"; later versions keep a strided shard), and
# an op whose rule wants a sharded operand made partial ("redistribute from
# S(0) to P(sum) not supported yet"; zamba2's causal convolution).  Where
# it refuses, the merged dimensions are replicated, and the partial
# operands reduced, first; where it does not, nothing changes, so a
# version whose DTensor traces these keeps its own layouts and counts.
def _refuses_flatten(e: Exception) -> bool:
    return "Attempted to flatten" in str(e)


def _refuses_partial(e: Exception) -> bool:
    return "to P(" in str(e) and "not supported" in str(e)


def _reduced(tree):
    """``tree`` with every partial DTensor in it reduced (replicated on
    the mesh dimensions where it was partial)."""
    from torch.utils._pytree import tree_map

    def one(t):
        if not _is_dt(t) or not any(p.is_partial() for p in t.placements):
            return t
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return tree_map(one, tree)


def reshape(t: DTensor, shape: Sequence[int]) -> DTensor:
    """``t.reshape(shape)`` after ``fit_splits``; where DTensor refuses to
    merge a sharded dimension into the one before it, that dimension is
    replicated first."""
    t = fit_splits(t, shape)
    try:
        return t.reshape(shape)
    except RuntimeError as e:
        if not _refuses_flatten(e):
            raise
    shape = _resolved(t, shape)
    merged = {d for a, b in _split_groups(list(t.shape), shape)
              if len(a) > 1 for d in a[1:]}
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in merged else p
        for p in t.placements]).reshape(shape)


def _resolved(t, shape: Sequence[int]) -> list:
    """``shape`` with its -1 resolved against ``t``'s size."""
    shape = [int(n) for n in shape]
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = t.numel() // max(known, 1)
    return shape


def _split_groups(old: Sequence[int], new: Sequence[int]):
    """A reshape's groups: (old dims, new dims) whose sizes multiply to
    the same number, in order."""
    out, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        a, b, pa, pb = [i], [j], old[i], new[j]
        while pa != pb:
            if pa < pb and i + 1 < len(old):
                i += 1
                a.append(i)
                pa *= old[i]
            elif j + 1 < len(new):
                j += 1
                b.append(j)
                pb *= new[j]
            else:
                return out
        out.append((a, b))
        i, j = i + 1, j + 1
    return out


def fit_splits(t: DTensor, shape: Sequence[int]) -> DTensor:
    """``t`` with every dimension that ``reshape(shape)`` splits sharded
    only over the leading mesh dimensions whose sizes the split's first
    factor divides; the rest replicated."""
    shape = _resolved(t, shape)
    mesh, placements = t.device_mesh, list(t.placements)
    changed = False
    for a, b in _split_groups(list(t.shape), shape):
        if len(a) != 1 or len(b) < 2:
            continue
        lead, ways = shape[b[0]], 1
        for m, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == a[0]:
                if lead % (ways * mesh.size(m)) == 0:
                    ways *= mesh.size(m)
                else:
                    placements[m], changed = Replicate(), True
    return t.redistribute(mesh, placements) if changed else t
