"""The reference's own training bars (``tests/test_substrate.py``) held by
the port on the CPU: AdamW converges on a quadratic, the loss falls over
8 steps, microbatched gradients equal unbatched ones, the data stream is
deterministic and host-sharded (and byte-equal to the reference's), the
prefetcher; and training leaves the serving path's frozen modules as
they were."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenSource as JaxTokenSource
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenSource
from repro_torch.models.zoo import build_model
from repro_torch.train import optimizer as optim
from repro_torch.train.step import init_train_state, make_train_step


def _tokens(cfg, B, T, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, T + 1))
    toks = torch.from_numpy(toks.astype(np.int32))
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = optim.OptConfig(lr=0.3, warmup_steps=1, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    state = optim.init(params)
    for _ in range(120):
        grads = {"w": 2 * state.master["w"]}
        params, state, _m = optim.apply(cfg, grads, state, params)
    assert params["w"].abs().max().item() < 1e-2


def test_train_step_loss_decreases():
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, optim.OptConfig(lr=5e-3, warmup_steps=2,
                                                  total_steps=100))
    batch = _tokens(cfg, 4, 16)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_train_step_microbatched_matches_unbatched_grads():
    """Two microbatches against one on llama3.2-1b: the loss within 1e-4
    relative and every gradient within 1e-4 of its tensor's largest
    |g|."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    opt = optim.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _tokens(cfg, 4, 8)
    out = []
    for n in (1, 2):
        state = init_train_state(model, torch.Generator().manual_seed(0))
        state, metrics = make_train_step(model, opt, n)(state, batch)
        out.append((metrics, {k: p.grad.clone() for k, p in
                              state.params.named_parameters()}))
    (m1, g1), (m2, g2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-4)
    for name, g in g1.items():
        bound = 1e-4 * g.abs().max().item()
        assert (g2[name] - g).abs().max().item() <= bound, name


def test_microbatched_metrics_keep_the_reference_quirk():
    """With two microbatches on a MoE config the reference reports the
    whole loss, aux included, as ``ce`` and no ``moe_aux``; the port
    reports the same keys and values (1e-5 relative) from the same
    parameters and batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.zoo import build_model as jax_build
    from repro.train import optimizer as jax_optim
    from repro.train.step import TrainState as JaxState
    from repro.train.step import make_train_step as jax_train_step
    from repro_torch.convert import params_from_jax
    from repro_torch.train.step import TrainState

    arch_id = "llama4-maverick-400b-a17b"
    jcfg, cfg = jax_get_config(arch_id).reduced(), get_config(arch_id).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _tokens(cfg, 4, 8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    _s, jmet = jax.jit(jax_train_step(jmodel, jax_optim.OptConfig(**kw), 2))(
        JaxState(jparams, jax_optim.init(jparams)),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu").requires_grad_(True)
    state = TrainState(params, optim.init(dict(params.named_parameters())))
    _s, met = make_train_step(build_model(cfg, device="cpu"),
                              optim.OptConfig(**kw), 2)(state, batch)
    assert set(met) == set(jmet) == {"ce", "grad_norm", "loss", "lr"}
    assert float(met["ce"]) == float(met["loss"])
    for key in ("ce", "loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)


def test_data_deterministic_and_host_sharded():
    c1 = DataConfig(seq_len=16, global_batch=8, vocab=100, n_hosts=2,
                    host_id=0)
    c2 = DataConfig(seq_len=16, global_batch=8, vocab=100, n_hosts=2,
                    host_id=1)
    a0 = TokenSource(c1).batch_at(3)
    a0b = TokenSource(c1).batch_at(3)
    b0 = TokenSource(c2).batch_at(3)
    np.testing.assert_array_equal(a0["inputs"], a0b["inputs"])
    assert not np.array_equal(a0["inputs"], b0["inputs"])
    assert a0["inputs"].shape == (4, 16)
    np.testing.assert_array_equal(a0["inputs"][:, 1:], a0["labels"][:, :-1])


@pytest.mark.parametrize("token_file", [False, True])
def test_batch_at_byte_equal_to_reference(token_file, tmp_path):
    """``batch_at`` of the synthetic stream and of a memmapped uint16
    token file is the reference's, byte for byte, on every host."""
    kw = dict(seq_len=12, global_batch=6, vocab=500, n_hosts=3, seed=7)
    if token_file:
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 500, 5000).astype(
            np.uint16).tofile(path)
        kw["token_file"] = str(path)
    for host in range(3):
        got = TokenSource(DataConfig(host_id=host, **kw)).batch_at(5)
        want = JaxTokenSource(JaxDataConfig(host_id=host, **kw)).batch_at(5)
        for key in ("inputs", "labels"):
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes()


def test_prefetcher():
    src = TokenSource(DataConfig(seq_len=8, global_batch=2, vocab=50))
    pf = Prefetcher(src, start_step=0)
    step0, b0 = next(pf)
    step1, b1 = next(pf)
    pf.close()
    assert (step0, step1) == (0, 1)
    np.testing.assert_array_equal(b0["inputs"], src.batch_at(0)["inputs"])


@pytest.mark.parametrize("arch_id", ["llama3.2-1b", "rwkv6-1.6b",
                                     "zamba2-1.2b"])
def test_training_leaves_serving_modules_frozen(arch_id):
    """A module from ``Model.init`` keeps every parameter frozen, and its
    ``prefill`` logits are the same before and after a train step on
    another module of the same model."""
    cfg = get_config(arch_id).reduced()
    model = build_model(cfg, device="cpu")
    serving = model.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in serving.parameters())
    batch = _tokens(cfg, 2, 8)
    lengths = torch.full((2,), 8)
    before, _ = model.prefill(serving, batch["inputs"], lengths)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in state.params.parameters())
    make_train_step(model, optim.OptConfig(lr=1e-2))(state, batch)
    after, _ = model.prefill(serving, batch["inputs"], lengths)
    assert not any(p.requires_grad or p.grad is not None
                   for p in serving.parameters())
    assert not after.requires_grad
    assert torch.equal(before, after)
    trained, _ = model.prefill(state.params, batch["inputs"], lengths)
    assert not torch.equal(trained, before)
