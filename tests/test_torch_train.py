"""The port's training path (``repro_torch.train``, ``Model.train_logits``)
against the JAX reference on the CPU, in float32 at ``reduced()`` size.

One train step per family from the same parameters (carried over by
``params_from_jax``) and the same batch: loss and ``grad_norm`` within
1e-5 relative, and each gradient within 1e-4 of its tensor's largest |g|,
compared by name through ``params_from_jax`` on the reference's gradient
tree (gradients, not the params after Adam: at step 1 ``m_hat /
sqrt(v_hat)`` is sign(g) wherever |g| >> eps, so a gradient near 0 whose
sign differs between the frameworks moves a parameter by a whole lr).
MoE expert choices must be equal.  The optimizer alone is fed the same
gradients on both sides (1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
from repro.configs.registry import get_config as jax_get_config
from repro.models.zoo import build_model as jax_build
from repro.train import optimizer as jax_optim
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
import repro_torch.models.moe as moe
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.train import optimizer as optim
from repro_torch.train.step import (TrainState, cross_entropy,
                                    init_train_state, make_train_step)

FAMILIES = ["llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b",
            "llama4-maverick-400b-a17b", "deepseek-v3-671b",
            "musicgen-large", "llava-next-mistral-7b"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def _batch(cfg, B=2, T=8, seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.input_mode == "tokens":
        toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    return {"inputs": rng.normal(size=(B, T, cfg.d_model)).astype(np.float32),
            "labels": labels}


def _port_state(np_params, cfg):
    params = params_from_jax(np_params, cfg, device="cpu")
    params.requires_grad_(True)
    return TrainState(params, optim.init(dict(params.named_parameters())))


def _grads_close(port_params, np_grads, cfg):
    want = dict(params_from_jax(np_grads, cfg, device="cpu")
                .named_parameters())
    for name, p in port_params.named_parameters():
        g, w = p.grad, want[name].detach()
        bound = 1e-4 * w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= bound, f"{name}: {err} > {bound}"


def _jax_routes(jmodel, jparams, inputs):
    """The reference's expert choices (top-k indices) of every MoE layer in
    one forward, in layer order."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[1],
                           ordered=True)
        return out

    jax_moe.jax.lax.top_k = recording
    try:
        jax.block_until_ready(jmodel.train_logits(jparams, inputs,
                                                  remat=False))
        jax.effects_barrier()
    finally:
        jax_moe.jax.lax.top_k = top_k
    return seen


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_train_step_matches_jax(arch_id, monkeypatch):
    """One step from the reference's parameters on one batch: metrics,
    every gradient by name, and (MoE) the expert choices and kept choices
    of the forward, held to the reference's and to a plain k-major loop
    at the capacity."""
    jcfg, cfg = jax_get_config(arch_id).reduced(), get_config(arch_id).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = (jparams, jax_optim.init(jparams))
    from repro.train.step import TrainState as JState
    _js, jmet = jax.jit(jax_train_step(jmodel, jax_optim.OptConfig(**OPT)))(
        JState(*jstate), jbatch)
    (_l, _m), jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel),
                                                  has_aux=True))(
        jparams, jbatch)

    model = build_model(cfg, device="cpu")
    state = _port_state(jax.tree.map(np.asarray, jparams), cfg)
    routes = []
    if cfg.moe:
        route = moe.moe_route

        def recording(router, xf, k, C):
            out = route(router, xf, k, C)
            routes.append((out[2].numpy().copy(), out[3].numpy().copy(), C))
            return out

        monkeypatch.setattr(moe, "moe_route", recording)
        with torch.no_grad():
            model.train_logits(state.params, torch.from_numpy(
                batch["inputs"]), remat=False)
        monkeypatch.undo()
    step = make_train_step(model, optim.OptConfig(**OPT))
    state, met = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert set(met) == set(jmet)
    for key in ("loss", "ce", "grad_norm") + (("moe_aux",) if cfg.moe
                                              else ()):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(met["lr"]) == float(jmet["lr"])
    _grads_close(state.params, jax.tree.map(np.asarray, jgrads), cfg)

    if cfg.moe:
        n_moe = cfg.n_layers - cfg.first_k_dense
        jroutes = _jax_routes(jmodel, jparams, jbatch["inputs"])
        assert len(jroutes) == len(routes) == n_moe
        for (idx, keep, C), want in zip(routes, jroutes):
            np.testing.assert_array_equal(idx, want)
            held = np.zeros(cfg.n_experts, int)
            want_keep = np.zeros_like(keep)
            for j in range(want.shape[1]):
                for n in range(want.shape[0]):
                    want_keep[n, j] = held[want[n, j]] < C
                    held[want[n, j]] += 1
            np.testing.assert_array_equal(keep, want_keep)


def test_optimizer_apply_matches_jax():
    """optim.apply fed the same numpy gradients on both sides, over three
    steps with the clip engaged: master, m and v within 1e-6; the params
    are the master cast back (bf16 here for one of them)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    w0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    cfg = dict(lr=3e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jparams = {n: jnp.asarray(a) for n, a in w0.items()}
    jparams["c"] = jparams["c"].astype(jnp.bfloat16)
    jstate = jax_optim.init(jparams)
    params = {n: torch.from_numpy(a.copy()) for n, a in w0.items()}
    params["c"] = params["c"].to(torch.bfloat16)
    state = optim.init(params)
    for _ in range(3):
        grads = {n: rng.normal(size=s).astype(np.float32)
                 for n, s in shapes.items()}
        jparams, jstate, jm = jax_optim.apply(
            jax_optim.OptConfig(**cfg), {n: jnp.asarray(g)
                                         for n, g in grads.items()},
            jstate, jparams)
        params, state, m = optim.apply(
            optim.OptConfig(**cfg), {n: torch.from_numpy(g)
                                     for n, g in grads.items()},
            state, params)
        assert state.step == int(jstate.step)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(m["lr"]) == float(jm["lr"])
        for n in shapes:
            for got, want in ((state.master, jstate.master),
                              (state.m, jstate.m), (state.v, jstate.v)):
                np.testing.assert_allclose(got[n].numpy(),
                                           np.asarray(want[n]), atol=1e-6,
                                           rtol=1e-6)
            assert params[n].dtype == (torch.bfloat16 if n == "c"
                                       else torch.float32)
            assert torch.equal(params[n], state.master[n].to(params[n].dtype))


@pytest.mark.parametrize("step", [0, 1, 2, 99, 100, 150])
def test_schedule_matches_jax(step):
    """Warmup and cosine: equal at steps 0, 1, the end of warmup, the
    total and past it."""
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    got = optim.schedule(optim.OptConfig(**cfg), step)
    want = jax_optim.schedule(jax_optim.OptConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_cross_entropy_matches_jax():
    from repro.train.step import cross_entropy as jax_ce
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_logits_remat_changes_nothing():
    """remat only moves memory: logits and gradients with and without it
    are equal."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(cfg)["inputs"])
    out = []
    for remat in (True, False):
        for p in state.params.parameters():
            p.grad = None
        logits, aux = model.train_logits(state.params, toks, remat=remat)
        logits.float().square().mean().backward()
        out.append((logits.detach(), [p.grad.clone() for p in
                                      state.params.parameters()]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
