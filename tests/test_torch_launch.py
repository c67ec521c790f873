"""The port's launch layer (``repro_torch.launch``): its registry cells
equal the reference's; the dry run of llama3.2-1b at ``reduced()`` on a
2x2 fake mesh ends ``ok`` for each kind, with argument bytes equal to the
sum of the local shards' sizes (each shard the global shape divided by
the mesh axes its spec names); the kernels on the traced paths take their
shape-only branches (costs reported, nothing launched); the CLI traces a
full-size cell on the 16x16 production mesh; and the SSD scan's one
traced chunk, counted T / SCAN_CHUNK times, equals the scan traced
whole."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

import repro.configs.registry as ref_registry
import repro_torch.models.mamba2 as mamba2
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh, release
from repro_torch.launch.specs import (abstract_cache, abstract_params,
                                      abstract_train_state,
                                      decode_input_specs, local_shape,
                                      train_batch_specs)
from repro_torch.models.zoo import build_model
from repro_torch.roofline.hlo import TraceCounter, cost_terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mesh():
    m = fake_mesh((2, 2), ("data", "model"), device="cpu")
    yield m
    release()


@pytest.fixture
def reduced(monkeypatch):
    """The dry run traces each arch's reduced() config."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).reduced())


def test_registry_equals_the_reference():
    assert list(registry.SHAPES) == list(ref_registry.SHAPES)
    for name, cell in registry.SHAPES.items():
        assert dataclasses.asdict(cell) == \
            dataclasses.asdict(ref_registry.SHAPES[name])
    assert registry.all_cells() == ref_registry.all_cells()
    for arch in registry.ARCH_IDS:
        for name in registry.SHAPES:
            assert registry.runnable(get_config(arch),
                                     registry.SHAPES[name]) == \
                ref_registry.runnable(ref_registry.get_config(arch),
                                      ref_registry.SHAPES[name])


def _train_argument_bytes(cfg, mesh):
    """The train cell's abstract inputs rebuilt -- parameters, their
    float32 master / m / v, inputs and labels -- each local shard checked
    against the global shape divided by its placements' mesh axes; their
    bytes."""
    model = build_model(cfg, device="cpu")
    with FakeTensorMode():
        state = abstract_train_state(model, mesh)
        tensors = list(state.params.parameters()) + [
            t for d in (state.opt.master, state.opt.m, state.opt.v)
            for t in d.values()] + list(train_batch_specs(
                cfg, registry.SHAPES["train_4k"], mesh).values())
    total = 0
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for t in tensors:
        want = list(t.shape)
        for name, p in zip(mesh.mesh_dim_names, t.placements):
            if p.is_shard():
                want[p.dim] //= sizes[name]
        assert list(t._local_tensor.shape) == want
        total += t._local_tensor.numel() * t._local_tensor.element_size()
    return total


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dry_run_each_kind_is_ok(shape, mesh, reduced):
    cfg = get_config("llama3.2-1b").reduced()
    before = decode_attn.launches
    rec = dryrun.run_cell("llama3.2-1b", shape, mesh, "2x2")
    assert rec["status"] == "ok"
    assert set(rec) >= {"arch", "shape", "mesh", "lower_s", "compile_s",
                        "bytes_per_device", "cost", "collective_bytes"}
    assert set(rec["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    assert rec["cost"]["flops"] > 0 and rec["bytes_per_device"]["temp"] > 0
    assert decode_attn.launches == before
    if shape == "train_4k":
        assert rec["bytes_per_device"]["argument"] == \
            _train_argument_bytes(cfg, mesh)


# The reference's dry run of reduced llama3.2-1b on a 2x2 mesh, in a
# process of its own (XLA's host device count is fixed at jax's first
# use).  Its mesh's axes are Auto: jax 0.9's make_mesh defaults to
# Explicit axes, under which the reference's embedding gather refuses to
# trace.  Besides XLA's figures it reports, from its own shardings, the
# bytes a device holds more in the port: a stacked leaf whose layer axis
# the reference shards is replicated there per layer (see
# repro_torch.dist.sharding).
_REFERENCE_DRY_RUN = r"""
import json, math
import jax
import numpy as np
from repro.configs import registry
from repro.launch import dryrun, specs
from repro.models.zoo import build_model
from repro.roofline.hlo import cost_terms
dryrun.get_config = lambda arch: registry.get_config(arch).reduced()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
out = {}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    lowered, _ = dryrun.lower_cell("llama3.2-1b", shape, mesh)
    compiled = lowered.compile()
    with mesh:
        model = build_model(dryrun.get_config("llama3.2-1b"))
        held = specs.abstract_train_state(model, mesh) \
            if shape == "train_4k" else specs.abstract_params(model, mesh)[0]
    layer_axis = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(held)[0]:
        entry = leaf.sharding.spec[0] if len(leaf.sharding.spec) else None
        if "layers'" not in jax.tree_util.keystr(path) or entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        ways = math.prod(sizes[n] for n in names)
        local = math.prod(leaf.sharding.shard_shape(leaf.shape))
        layer_axis += local * np.dtype(leaf.dtype).itemsize * (ways - 1)
    out[shape] = {
        "argument": compiled.memory_analysis().argument_size_in_bytes,
        "flops": cost_terms(compiled)["flops"],
        "layer_axis": layer_axis}
print(json.dumps(out))
"""


def test_dry_run_agrees_with_the_reference(mesh, reduced):
    """Each kind's argument bytes a device equal the reference's
    ``memory_analysis`` but for three differences, each counted: the
    layer axes the port replicates; the train state's step, an int32
    leaf there (4 bytes) and a Python int here; and prefill's ``lens``,
    which jit prunes from llama's prefill (unused) and the port passes.
    Flops a device lie within 0.8x-2.5x of the reference's
    ``cost_analysis``: the two count the same dense attention, but XLA's
    figure for train and prefill is about half the port's 2 M N K per
    einsum (torch 2.13, jax 0.9: decode 0.94x, prefill 1.78x, train
    2.30x); DTensor leaving sharded work replicated would push the ratio
    past the bound."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_DRY_RUN],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for shape, want in ref.items():
        rec = dryrun.run_cell("llama3.2-1b", shape, mesh, "2x2")
        assert rec["status"] == "ok", rec
        extra = want["layer_axis"]
        if shape == "train_4k":
            extra -= 4
        if shape == "prefill_32k":
            extra += registry.SHAPES[shape].global_batch * 4
        assert rec["bytes_per_device"]["argument"] == \
            want["argument"] + extra, shape
        ratio = rec["cost"]["flops"] / want["flops"]
        assert 0.8 <= ratio <= 2.5, (shape, ratio)


def test_decode_argument_bytes_are_the_local_shards(mesh, reduced):
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    cell = registry.SHAPES["decode_32k"]
    lowered, _ = dryrun.lower_cell("llama3.2-1b", "decode_32k", mesh)
    with FakeTensorMode():
        params, specs = abstract_params(model, mesh)
        caches = abstract_cache(model, cell.global_batch, cell.seq_len, mesh)
        inputs = decode_input_specs(cfg, cell, mesh)
    total = 0
    for name, p in params.named_parameters():
        assert tuple(p._local_tensor.shape) == local_shape(p.shape,
                                                           specs[name], mesh)
        total += p._local_tensor.numel() * p._local_tensor.element_size()
    for t in tree_leaves(caches) + list(inputs):
        total += t._local_tensor.numel() * t._local_tensor.element_size()
    assert lowered.argument_bytes == total
    # one decode_attn call a layer, on its shape-only branch
    assert lowered.trace.kernels == {"decode_attn": cfg.n_layers}


def test_rwkv6_training_traces_wkv6_shape_only(mesh, reduced):
    cfg = get_config("rwkv6-1.6b").reduced()
    before = (wkv6.launches, dict(wkv6.launches_by_route))
    lowered, _ = dryrun.lower_cell("rwkv6-1.6b", "train_4k", mesh)
    assert lowered.trace.kernels == {"wkv6": cfg.n_layers,
                                     "wkv6 backward": cfg.n_layers}
    assert (wkv6.launches, dict(wkv6.launches_by_route)) == before


def test_cli_traces_a_full_size_cell(tmp_path):
    out = tmp_path / "d.json"
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                      "--device", "cpu", "--out", str(out)])
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    # 16 layers of K/V cache, (128, 8, 32768, 64) bf16 each, batch on
    # "data" and sequence on "model": a 256th of 2 x 16 x 2^31 bytes
    assert rec["bytes_per_device"]["argument"] >= 2 * 16 * 2 ** 31 // 256


def test_ssd_scan_counts_one_chunk_exactly(monkeypatch):
    """Traced once and counted T / SCAN_CHUNK times = traced whole."""
    B, T, nh, hp, ds = 2, 2 * mamba2.SCAN_CHUNK, 2, 4, 3

    def count():
        with FakeTensorMode():
            xs = torch.empty(B, T, nh, hp)
            Bm, Cm = torch.empty(B, T, ds), torch.empty(B, T, ds)
            a, dt = torch.empty(B, T, nh), torch.empty(B, T, nh)
            S = torch.empty(B, nh, hp, ds)
            with torch.no_grad(), TraceCounter() as trace:
                y, _S = mamba2._ssd_scan(xs, Bm, Cm, a, dt, S)
        assert tuple(y.shape) == (B, T, nh, hp)
        return cost_terms(trace)

    repeated = count()
    monkeypatch.setattr(mamba2, "shape_only", lambda *t: False)
    assert count() == repeated


def test_strided_shard_arithmetic_equals_dtensors_own():
    """launch/rules.py's chunk arithmetic gives DTensor's own strided-shard
    sizes and offsets (computed by splitting an index range), in every
    offset mode, even and uneven."""
    import itertools
    from torch.distributed.tensor import placement_types as pt
    from repro_torch.launch import rules
    rules.install()
    own = pt._StridedShard.__dict__.get("local_shard_size_and_offset")
    assert own is rules.strided_size_and_offset
    original = rules._DTENSOR_STRIDED_SIZE
    modes = [m for m in (getattr(pt, "_StridedShardOffsetMode", None),)
             if m is not None]
    modes = list(modes[0]) if modes else [True, False]
    for n, factor, chunks in itertools.product((0, 1, 7, 16, 48, 100),
                                               (1, 2, 3, 16), (1, 2, 4, 16)):
        p = pt._StridedShard(0, split_factor=factor)
        for rank in range(chunks):
            for mode in modes:
                assert rules.strided_size_and_offset(p, n, chunks, rank,
                                                     mode) == \
                    original(p, n, chunks, rank, mode), (n, factor, chunks,
                                                         rank, mode)


def test_meshes_have_the_reference_shapes_and_names():
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_smoke_mesh)
    try:
        for multi_pod, shape, names in (
                (False, (16, 16), ("data", "model")),
                (True, (2, 16, 16), ("pod", "data", "model"))):
            m = make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert tuple(m.shape) == shape and m.mesh_dim_names == names
            assert m.device_type == "cpu"
        m = make_smoke_mesh(device="cpu")
        assert tuple(m.shape) == (1, 1)
        assert m.mesh_dim_names == ("data", "model")
    finally:
        release()


def test_model_gaps_give_dtensors_the_models_idioms(mesh):
    """Under the dry run's function mode: a reshape that splits a
    dimension sharded 4 ways into (2, 3) keeps the shard its leading
    factor divides and replicates the rest; a 2-D table indexed by ids is
    an embedding lookup on the whole table; a layer written back into its
    stack keeps the stack's layout; and a remat recompute runs under the
    mode too (the forward's function modes are re-entered there)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch.rules import ModelGaps
    from repro_torch.models.transformer import _recompute_as_forward

    def dt(shape, placements, dtype=torch.float32):
        local = list(shape)
        for size, p in zip(mesh.shape, placements):
            if isinstance(p, Shard):
                local[p.dim] //= size
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                                  placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape).stride())

    with FakeTensorMode(), ModelGaps():
        x = dt((4, 8), [Shard(1), Shard(1)])
        y = x.reshape(4, 2, 4)          # 2 divides the 4 shards' first 2
        assert tuple(y.shape) == (4, 2, 4)
        assert y.placements[0] == Shard(1)
        z = dt((4, 6), [Shard(1), Shard(1)]).reshape(4, 2, 3)
        assert tuple(z.shape) == (4, 2, 3)
        assert z.placements == (Shard(1), Replicate())
        table = dt((16, 8), [Shard(0), Shard(1)])
        ids = dt((4, 3), [Shard(0), Replicate()], torch.int64)
        rows = table[ids]
        assert tuple(rows.shape) == (4, 3, 8)
        assert rows.placements == (Shard(0), Shard(2))
        stack = dt((3, 4, 8), [Replicate(), Shard(2)])
        stack[1] = dt((4, 8), [Shard(0), Replicate()])
        assert stack.placements == (Replicate(), Shard(2))
        plain = torch.empty(4, 6)
        assert plain.reshape(4, 2, 3).shape == (4, 2, 3)

    seen = []

    class Seen(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.reshape:
                seen.append("reshape")
            return func(*args, **(kwargs or {}))

    w = torch.ones(6, requires_grad=True)
    with Seen():
        out = checkpoint(lambda v: v.sin().reshape(2, 3).exp().sum(), w,
                         use_reentrant=False,
                         context_fn=_recompute_as_forward)
        out.backward()
    assert seen == ["reshape", "reshape"]       # forward and recompute


def test_index_put_rule_replicates_or_shards_trailing_dims():
    """The index_put rule ``install`` registers where DTensor has none
    (torch 2.11): everything replicated, or ``self`` and ``values``
    sharded alike on a dimension the index tensors leave whole; with a
    ``None`` index, only replicated.  After ``install`` DTensor has a rule
    for both index_put ops on every version."""
    from types import SimpleNamespace as Spec

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import rules
    every = ([Replicate()], [Replicate()] * 4 + [None])
    got = rules._index_put(Spec(ndim=3), [Spec(ndim=1), Spec(ndim=1)],
                           Spec(ndim=2))
    assert got == [every, ([Shard(2)], [Shard(2), Replicate(), Replicate(),
                                        Shard(1), None])]
    assert rules._index_put(Spec(ndim=3), [Spec(ndim=1), None],
                            Spec(ndim=2)) == [every]
    rules.install()
    prop = DTensor._op_dispatcher.sharding_propagator
    for op in (torch.ops.aten.index_put_.default,
               torch.ops.aten.index_put.default):
        assert rules._has_strategy(prop, op)


# ---------------------------------------------- C15: the dry run's repairs
def test_granite_prefill_takes_the_local_einsum(monkeypatch):
    """granite-34b's prefill_32k at full width, cut to one layer (the
    fault is per layer), on the 16x16 production mesh, where its
    attention einsum at MQA's G 48 meets a partial V beside probabilities
    sharded on G: computed on the local shards, with V reduced, instead
    of DTensor gathering the probabilities chunk by chunk (a 32768-piece
    strided shard; minutes a layer, past 1200 s at 88 layers)."""
    from repro_torch.launch import rules
    from repro_torch.launch.mesh import make_production_mesh
    seen = []
    local = rules.einsum_on_shards

    def spy(equation, *operands):
        seen.append(equation)
        return local(equation, *operands)

    monkeypatch.setattr(rules, "einsum_on_shards", spy)
    mesh = make_production_mesh(device="cpu")
    try:
        rec = dryrun.run_cell("granite-34b", "prefill_32k", mesh, "16x16",
                              num_layers=1)
    finally:
        release()
    assert rec["status"] == "ok" and rec["n_layers"] == 1
    assert seen == ["bhgts,bshd->bthgd"]
    # the probabilities (32 x 48 x 32768^2 float32) are never gathered
    assert rec["collective_bytes"]["all-gather"] < 32 * 48 * 32768 ** 2 * 4 / 256


def _dt(mesh, shape, placements, dtype=torch.float32):
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape).stride())


def test_einsum_on_shards_layouts(mesh):
    """The local einsum's placements: an operand's shard letter shards the
    others that have it and the output (partial where it is summed over);
    of two letters on one mesh dimension the larger operand's wins; the
    largest partial operand stays partial; and the local product has the
    local shapes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.rules import einsum_on_shards
    with FakeTensorMode():
        p = _dt(mesh, (4, 1, 8, 6, 6), [Shard(0), Shard(2)])
        v = _dt(mesh, (4, 6, 1, 16), [Shard(0), Partial()])
        out = einsum_on_shards("bhgts,bshd->bthgd", p, v)
        assert tuple(out.shape) == (4, 6, 1, 8, 16)
        assert out.placements == (Shard(0), Shard(3))
        assert tuple(out.to_local().shape) == (2, 6, 1, 4, 16)
        q = _dt(mesh, (4, 1, 8, 16), [Partial(), Shard(2)])
        k = _dt(mesh, (4, 64, 8, 16), [Partial(), Shard(0)])
        out = einsum_on_shards("bthd,bshd->bhts", q, k)
        assert tuple(out.shape) == (4, 8, 1, 64)
        assert out.placements == (Partial(), Shard(0))
        a = _dt(mesh, (8, 16), [Replicate(), Shard(1)])
        b = _dt(mesh, (16, 4), [Replicate(), Replicate()])
        out = einsum_on_shards("ij,jk->ik", a, b)
        assert out.placements == (Replicate(), Partial())
        assert tuple(out.to_local().shape) == (8, 4)


def test_refused_flatten_replicates_the_merged_dimension(mesh, monkeypatch):
    """Where DTensor refuses a view that merges a sharded dimension into
    the one before it (torch 2.11: MoE's k-major choices), ``reshape``
    replicates that dimension first; elsewhere it is DTensor's own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import rules
    own = DTensor.reshape

    def refusing(self, *shape):
        if any(isinstance(p, Shard) and p.dim > 0 for p in self.placements):
            raise RuntimeError("('Attempted to flatten multiple dimensions, "
                               "with dimension 1 being sharded. ', '...')")
        return own(self, *shape)

    monkeypatch.setattr(DTensor, "reshape", refusing)
    with FakeTensorMode():
        x = _dt(mesh, (2, 16, 8), [Shard(1), Replicate()])
        y = rules.reshape(x, (-1, 8))
        assert tuple(y.shape) == (32, 8)
        assert y.placements == (Replicate(), Replicate())
        z = rules.reshape(_dt(mesh, (4, 16), [Shard(0), Replicate()]),
                          (2, 2, 16))
        assert z.placements == (Shard(0), Replicate())


def test_refused_einsum_runs_on_the_local_shards(mesh, monkeypatch):
    """Where DTensor refuses an einsum's flattening of a sharded dimension
    (torch 2.11: MLA's attention at decode), the einsum runs on the local
    shards."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.launch import rules
    own = torch.einsum

    def refusing(equation, *operands):
        if any(isinstance(a, DTensor) for a in operands):
            raise RuntimeError("('Attempted to flatten multiple dimensions, "
                               "with dimension 1 being sharded. ', '...')")
        return own(equation, *operands)

    monkeypatch.setattr(torch, "einsum", refusing)
    with FakeTensorMode():
        q = _dt(mesh, (4, 1, 8, 16), [Partial(), Shard(2)])
        k = _dt(mesh, (4, 64, 8, 16), [Shard(0), Shard(2)])
        out = rules.einsum("bthd,bshd->bhts", q, k)
    assert tuple(out.shape) == (4, 8, 1, 64)
    assert out.placements == (Shard(0), Shard(1))


def test_refused_partial_is_reduced_first():
    """DTensor's refusal to make a sharded operand partial (torch 2.11:
    zamba2's causal convolution) is recognised, and ``_reduced`` turns
    every partial DTensor of the arguments into a replicated one."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch import rules
    assert rules._refuses_partial(RuntimeError(
        "redistribute from S(0) to P(sum) not supported yet"))
    assert not rules._refuses_partial(RuntimeError("shapes differ"))
    m = fake_mesh((2, 2), ("data", "model"), device="cpu")
    try:
        with FakeTensorMode():
            a = _dt(m, (4, 8), [Shard(0), Partial()])
            b = _dt(m, (4, 8), [Shard(0), Replicate()])
            ra, rb, n = rules._reduced((a, b, 3))
        assert ra.placements == (Shard(0), Replicate()) and rb is b and n == 3
    finally:
        release()


def test_microbatch_split_of_plain_and_distributed_batches(mesh):
    """A plain batch splits into its consecutive rows, as the reference
    splits it; a DTensor batch into the same part of each device's rows,
    in the batch's placements, so each microbatch keeps every device's
    share of the work."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.train.step import microbatch
    x = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(microbatch(x, 4, 1), x[2:4])
    local = torch.arange(4 * 3).reshape(4, 3)
    d = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                           run_check=False, shape=torch.Size((8, 3)),
                           stride=(3, 1))
    part = microbatch(d, 2, 1)
    assert tuple(part.shape) == (4, 3)
    assert part.placements == (Shard(0), Replicate())
    assert torch.equal(part.to_local(), local[2:4])


@pytest.mark.parametrize("variant", ["mb4", "mb8", "mb16", "mb8+logits",
                                     "mb16+logits"])
def test_hillclimb_microbatch_variants_trace(variant, mesh, monkeypatch):
    """Each microbatched variant of the hill-climb traces reduced
    llama3.2-1b's train step on the 2x2 mesh with the one-microbatch
    step's flops (its own ``logits`` twin's for +logits), and its
    temporaries shrink with the microbatches: under 1.25 / n of the
    one-microbatch step's."""
    from repro_torch.roofline import hillclimb
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).reduced())
    base = "logits" if variant.endswith("+logits") else "baseline"
    got = {name: hillclimb.eval_variant("llama3.2-1b", "train_4k", mesh,
                                        hillclimb.VARIANTS[name])
           for name in (base, variant)}
    n = hillclimb.VARIANTS[variant]["microbatches"]
    assert got[variant]["gflops"] == got[base]["gflops"]
    assert got[variant]["temp_gb"] <= 1.25 * got[base]["temp_gb"] / n


def test_matmul_gathers_a_weight_sharded_with_the_batch(mesh):
    """Under the dry run's function mode ``x @ w`` gathers a trained 2-D
    weight along the mesh dimensions that shard ``x``'s batch (FSDP), so
    the product keeps the batch sharded where DTensor alone, the
    activation being the smaller, would move it instead (and repeat the
    product on every device of the data axis); a weight sharded
    elsewhere, one that is not trained (serving), or a product of two
    activations keeps DTensor's own layouts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch import rules
    rules.install()
    with FakeTensorMode():
        x = _dt(mesh, (2, 2, 8), [Shard(0), Shard(2)])
        w = _dt(mesh, (8, 256), [Shard(1), Shard(0)])
        frozen = w.detach()
        w.requires_grad_(True)
        other = _dt(mesh, (8, 256), [Replicate(), Shard(0)])
        other.requires_grad_(True)
        with rules.ModelGaps():
            y = x @ w
            z = torch.matmul(x, other)
            served = x @ frozen
        assert tuple(y.shape) == (2, 2, 256)
        assert y.placements == (Shard(0), Partial())
        assert z.placements == (Shard(0), Partial())
        assert served.placements == (x @ frozen).placements
        b = _dt(mesh, (2, 8, 6), [Shard(0), Shard(1)])
        assert rules.matmul(x, b).placements == (x @ b).placements


@pytest.mark.parametrize("n", [2, 4])
def test_microbatches_keep_the_flops_at_one_row_a_device(n, mesh,
                                                         monkeypatch):
    """Reduced llama3.2-1b's train step on the 2x2 mesh at B 8 x T 32,
    where ``n`` 4 leaves each device one row a microbatch and a
    microbatch's activations are smaller than the weights they meet:
    the step's flops equal the one-microbatch step's (DTensor alone would
    gather the activations and repeat the products on every device of the
    data axis: 6.3% and 10.4% more flops) and its temporaries shrink."""
    from repro_torch.configs.registry import ShapeCell
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).reduced())
    monkeypatch.setitem(dryrun.SHAPES, "train_tiny",
                        ShapeCell("train_tiny", 32, 8, "train"))
    got = {}
    for mb in (1, n):
        lowered, _ = dryrun.lower_cell("llama3.2-1b", "train_tiny", mesh,
                                       microbatches=mb)
        got[mb] = (cost_terms(lowered.trace)["flops"], lowered.temp_bytes)
    assert got[n][0] == got[1][0]
    assert got[n][1] < got[1][1]
