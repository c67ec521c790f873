"""Port's MLA (deepseek-v3's latent-KV attention) against the JAX
reference on the CPU, at serve_smoke_config size: the prefill's output
and latent cache, then 3 chained decode steps into a cache of S
positions (ragged rows, each writing only positions that were empty,
where the reference's additive write and the port's assignment agree),
outputs and cache compared.  Float32, 1e-4 (rtol and atol)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.models.attention import mla_forward as jax_mla
from repro.models.zoo import build_model as jax_build
from repro_torch.configs.registry import serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.attention import mla_forward

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T, S = 2, 8, 16


def _attn():
    jcfg, tcfg = jax_smoke(ARCH), serve_smoke_config(ARCH)
    assert tcfg.mla
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jattn = jax.tree.map(lambda a: a[0], jp["dense_layers"]["attn"])
    return jcfg, tcfg, jattn, tp.dense_layers[0].attn


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_prefill_cache_and_decode_match_jax():
    jcfg, tcfg, jattn, tattn = _attn()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    jout, jlat = jax_mla(jattn, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        out, lat = mla_forward(tattn, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    width = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    assert lat.shape == (B, T, width)
    _close(out, jout)
    _close(lat, jlat)

    jcache = jnp.zeros((B, S, width)).at[:, :T].set(jlat)
    cache = torch.zeros((B, S, width))
    cache[:, :T] = lat
    for t in range(3):
        step = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
        p = np.array([[T + t], [T + 1 + t]])
        lens = p[:, 0] + 1
        jout, jcache = jax_mla(jattn, jcfg, jnp.asarray(step),
                               jnp.asarray(p), jcache, jnp.asarray(lens))
        with torch.no_grad():
            out, new = mla_forward(tattn, tcfg, torch.from_numpy(step),
                                   torch.from_numpy(p), cache,
                                   torch.from_numpy(lens))
        assert new is cache                      # written in place
        _close(out, jout)
    _close(cache, jcache)
    # rows past each length were never written
    assert not cache[0, T + 3:].any() and not cache[1, T + 4:].any()


def test_mla_decode_overwrites_a_reused_position():
    """A decode step writes its latents by assignment: stale latents at
    the position (a recycled slot's) give the result of a clean cache,
    where the reference's additive write would sum onto them (ROADMAP
    C3)."""
    _, tcfg, _, tattn = _attn()
    rng = np.random.default_rng(1)
    width = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    clean = torch.from_numpy(rng.normal(size=(B, S, width))
                             .astype(np.float32))
    clean[:, T:] = 0
    stale = clean.clone()
    stale[:, T:] = torch.from_numpy(rng.normal(size=(B, S - T, width))
                                    .astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(B, 1, tcfg.d_model))
                            .astype(np.float32))
    p = torch.full((B, 1), T)
    lens = torch.full((B,), T + 1)
    with torch.no_grad():
        want, _ = mla_forward(tattn, tcfg, step, p, clean, lens)
        got, _ = mla_forward(tattn, tcfg, step, p, stale, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(stale[:, :T + 1], clean[:, :T + 1], rtol=0,
                               atol=0)
