"""Port's Mamba2 (SSD) block and zamba2 hybrid against the JAX reference
on the CPU.  The block: from zero state and from a given one, over 1, 2
(shorter than the conv kernel's K-1 = 3 rows of context), 8 and 300
steps (more than the scan's chunk of 256); output, conv context and SSM
state compared.  The hybrid at a depth its shared block's period does
not divide (7 layers, every 3rd: two applications, a last layer
without): prefill logits and caches, then 3 chained decode steps.
Float32, 1e-4 (rtol and atol)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.models.mamba2 import mamba2_block as jax_block
from repro.models.zoo import build_model as jax_build
from repro_torch.configs.registry import serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.mamba2 import SCAN_CHUNK, mamba2_block, mamba_dims
from repro_torch.models.zoo import build_model, cache_tensors

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _models(**changes):
    jcfg = dataclasses.replace(jax_smoke(ARCH), **changes)
    tcfg = dataclasses.replace(serve_smoke_config(ARCH), **changes)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return tcfg, (jm, jp), (tm, tp)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 2, 8, 300])
def test_mamba2_block_matches_jax(T, with_state):
    assert 8 < SCAN_CHUNK < 300
    cfg, (jm, jp), (_, tp) = _models()
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"])
    rng = np.random.default_rng(T)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    d_inner, nh, hp, ds = mamba_dims(cfg)
    state = None
    if with_state:
        state = (rng.normal(size=(B, cfg.conv_kernel - 1,
                                  d_inner + 2 * ds)).astype(np.float32),
                 rng.normal(size=(B, nh, hp, ds)).astype(np.float32))
    jout, (jconv, jssm) = jax_block(
        jlayer, jm.cfg, jnp.asarray(x),
        None if state is None else tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        out, (conv, ssm) = mamba2_block(
            tp.layers[1], cfg, torch.from_numpy(x),
            None if state is None else tuple(map(torch.from_numpy, state)))
    assert ssm.dtype == torch.float32
    _close(out, jout)
    _close(conv, jconv)
    _close(ssm, jssm)


def test_zamba2_hybrid_matches_jax_at_an_uneven_depth():
    cfg, (jm, jp), (tm, tp) = _models(n_layers=7, attn_every=3)
    rng = np.random.default_rng(0)
    T, S = 8, 16
    toks = rng.integers(0, cfg.vocab, (B, T))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray([T] * B))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), torch.tensor([T] * B))
    _close(tl, jl)
    got, want = cache_tensors(tc), jax.tree.leaves(jc)
    assert [tuple(g.shape) for g in got] == [
        (7, B, 3, 160), (7, B, 4, 32, 16), (2, B, 4, T, 16),
        (2, B, 4, T, 16)]
    for g, w in zip(got, want):
        _close(g, w)

    (jm_st, (jk, jv)) = jm.init_cache(B, S)
    jcache = (jc[0], (jk.at[:, :, :, :T].set(jc[1][0]),
                      jv.at[:, :, :, :T].set(jc[1][1])))
    tcache = tm.init_cache(B, S)
    for full, new in zip(cache_tensors(tcache), got):
        if full.shape == new.shape:
            full.copy_(new)
        else:
            full[:, :, :, :T] = new
    for t in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        pos = np.array([[T + t], [T + 1 + t]])
        lens = pos[:, 0] + 1
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(lens))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos), torch.from_numpy(lens))
        _close(tl, jl)
    for g, w in zip(cache_tensors(tcache), jax.tree.leaves(jcache)):
        _close(g, w)
