"""The port's Checkpointer (``repro_torch.checkpoint.checkpointer``)
against the reference's: the reference's substrate cases (round trip,
async + keep-k GC, restore onto another placement: a device and a 1-rank
gloo DeviceMesh), and checkpoints moving both ways between the packages
at ``reduced()`` size for a dense, an SSM and a MoE config.  A state the
JAX package writes after one step restores into the port's TrainState,
whose next step equals the reference's next step at test_torch_train.py's
tolerance (loss / grad_norm 1e-5 relative, gradients 1e-4 of max|g|);
the port writes that state back, the JAX package restores it and every
leaf is word-equal; both manifest.json files are byte-equal.  bfloat16
leaves travel as their 16-bit words both ways.  A background write that
fails raises from ``wait``, and a checkpoint of other leaves is refused."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.registry import get_config as jax_get_config
from repro.models.zoo import build_model as jax_build
from repro.train import optimizer as jax_optim
from repro.train.step import init_train_state as jax_init_state
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.train import optimizer as optim
from repro_torch.train.step import init_train_state, make_train_step

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
INTEROP = ["llama3.2-1b", "rwkv6-1.6b", "llama4-maverick-400b-a17b"]


# ------------------------------------------------ the reference's cases
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    ck.save(1, tree, blocking=True)
    ck.save(5, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}},
            blocking=True)
    like = {"a": torch.zeros(2, 3, dtype=torch.int64),
            "b": {"c": torch.zeros(4)}}
    out = ck.restore(5, like)
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"].numpy() * 2)
    assert out["a"] is like["a"]                 # restored in place
    assert ck.latest_step() == 5


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(8)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert ck.all_steps() == [3, 4]


def test_checkpoint_restore_onto_device(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1)
    tree = {"w": torch.arange(16.0)}
    ck.save(7, tree, blocking=True)
    like = {"w": torch.zeros(16, dtype=torch.float64)}
    out = ck.restore(7, like, sharding_fn=lambda p, s: torch.device("cpu"))
    assert out["w"] is not like["w"] and out["w"].dtype == torch.float64
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())


def test_checkpoint_restore_onto_mesh(tmp_path):
    """A module's stacked leaf sharded over a 1-rank gloo DeviceMesh: each
    layer's parameter takes the stacked placement minus the layer axis."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = get_config("llama3.2-1b").reduced()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(3, {"p": params}, blocking=True)
    fresh = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", init_method="tcp://localhost:0",
                                rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        seen = {}

        def sharding_fn(path, shape):
            seen[path] = shape
            return mesh, [Shard(len(shape) - 1)]

        out = ck.restore(3, {"p": fresh}, sharding_fn=sharding_fn)["p"]
        assert seen["['p']['dense_layers']['attn']['wq']"] == \
            (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
        wq = out.dense_layers[1].attn.wq
        assert isinstance(wq, DTensor) and wq.placements == (Shard(1),)
        assert out.embed.placements == (Shard(1),)
        for (name, got), want in zip(out.named_parameters(),
                                     params.parameters()):
            assert torch.equal(got.full_tensor(), want), name
        from repro_torch.checkpoint.checkpointer import _drop_layer_axis
        assert _drop_layer_axis((mesh, [Shard(0)]))[1] == [Replicate()]
    finally:
        if owned:
            dist.destroy_process_group()


def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """An async save writes the state as it was when ``save`` returned,
    though the next step updates every CPU tensor in place (params,
    master, m, v) before the background write runs: the write is held
    until the step is done.  Restored word for word."""
    import threading
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, optim.OptConfig(**OPT))
    b0, b1 = _batch(cfg, 1), _batch(cfg, 2)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in b0.items()})
    want = [(p, t.detach().clone()) for p, t in _tensors_of(state)]

    go, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        go.wait()
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, state)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in b1.items()})
    assert state.opt.step == 2
    go.set()
    ck.wait()
    fresh = init_train_state(model, torch.Generator().manual_seed(9))
    got = ck.restore(1, fresh)
    assert got.opt.step == 1
    for (path, t), (wpath, w) in zip(_tensors_of(got), want):
        assert path == wpath
        assert t.dtype == w.dtype and torch.equal(t, w), path


def _tensors_of(state):
    """(name, tensor) for every tensor of a TrainState."""
    out = list(state.params.named_parameters())
    for part in ("master", "m", "v"):
        out += [(f"{part}.{k}", v)
                for k, v in getattr(state.opt, part).items()]
    return out


# ------------------------------------------------------ the two packages
def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch_id", INTEROP)
def test_checkpoints_move_between_packages(arch_id, tmp_path):
    jcfg, cfg = jax_get_config(arch_id).reduced(), \
        get_config(arch_id).reduced()
    jmodel = jax_build(jcfg)
    jstep = jax.jit(jax_train_step(jmodel, jax_optim.OptConfig(**OPT)))
    b0, b1 = _batch(cfg, 1), _batch(cfg, 2)
    jstate, _ = jstep(jax_init_state(jmodel, jax.random.PRNGKey(0)),
                      {k: jnp.asarray(v) for k, v in b0.items()})
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxCheckpointer(jdir).save(1, jstate, blocking=True)

    model = build_model(cfg, device="cpu")
    state = Checkpointer(jdir).restore(1, init_train_state(
        model, torch.Generator().manual_seed(5)))
    assert state.opt.step == 1

    # the port's next step = the reference's next step
    jnext, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b1.items()})
    (_l, _m), jgrads = jax.value_and_grad(jax_loss_fn(jmodel), has_aux=True)(
        jstate.params, {k: jnp.asarray(v) for k, v in b1.items()})
    Checkpointer(pdir).save(1, state, blocking=True)    # before stepping
    step = make_train_step(model, optim.OptConfig(**OPT))
    state, met = step(state, {k: torch.from_numpy(v) for k, v in b1.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(met["lr"]) == float(jmet["lr"])
    want = dict(params_from_jax(_np(jgrads), cfg, device="cpu")
                .named_parameters())
    for name, p in state.params.named_parameters():
        bound = 1e-4 * want[name].abs().max().item()
        assert (p.grad - want[name]).abs().max().item() <= bound, name

    # the port's checkpoint restores in the reference word for word
    back = JaxCheckpointer(pdir).restore(1, jstate)
    for (path, got), want_leaf in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree.leaves(jstate)):
        want_leaf = np.asarray(want_leaf)
        assert got.dtype == want_leaf.dtype and got.shape == want_leaf.shape
        assert got.tobytes() == want_leaf.tobytes(), \
            jax.tree_util.keystr(path)
    with open(os.path.join(jdir, "step_1", "manifest.json"), "rb") as f:
        jm = f.read()
    with open(os.path.join(pdir, "step_1", "manifest.json"), "rb") as f:
        assert f.read() == jm


def test_bfloat16_leaves_travel_as_words(tmp_path):
    """bf16 leaves: the reference writes |V2 words (and restores them
    uncast, C13); the port writes the same words and reads bf16 back."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "s": jnp.asarray(x[0])}
    JaxCheckpointer(str(tmp_path / "jax")).save(2, jtree, blocking=True)
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "s": torch.zeros(5)}
    got = Checkpointer(str(tmp_path / "jax")).restore(2, like)
    words = np.asarray(jtree["w"]).view(np.uint16)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy()
                                  .view(np.uint16), words)
    Checkpointer(str(tmp_path / "port")).save(2, got, blocking=True)
    back = JaxCheckpointer(str(tmp_path / "port")).restore(2, jtree)
    assert back["w"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(back["w"].view(np.uint16), words)
    np.testing.assert_array_equal(back["s"], x[0])
    for d in ("jax", "port"):
        with open(tmp_path / d / "step_2" / "manifest.json", "rb") as f:
            text = f.read()
        assert b'"dtype": "bfloat16"' in text
    assert (tmp_path / "jax" / "step_2" / "manifest.json").read_bytes() == \
        (tmp_path / "port" / "step_2" / "manifest.json").read_bytes()


def test_a_failed_background_write_raises_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, {"w": torch.ones(3)})
    ck.wait()
    (tmp_path / "step_2.tmp").write_text("a file where the step's dir goes")
    ck.save(2, {"w": torch.ones(3)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                    # raised once
    assert ck.all_steps() == [1]
    with pytest.raises(ValueError, match="leaf count"):
        ck.restore(1, {"w": torch.zeros(3), "x": torch.zeros(1)})
