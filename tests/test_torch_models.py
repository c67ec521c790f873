"""Port's llama model against the JAX reference on the CPU: the JAX
model's own parameters go through params_from_jax, then prefill logits,
prefill caches and four chained decode steps are compared.

Tolerances: 1e-4 (rtol and atol) in float32.  In bfloat16 the two
frameworks round matmul sums at other places; measured on the smoke
config the logits differ by at most 4.9e-3 and the caches by at most
1.95e-2 absolute, so bf16 is held to 1.5e-2 on logits and 3e-2 absolute
/ 2^-6 relative on caches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro_torch.configs.registry import get_config, serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.common import ModelConfig
from repro_torch.models.zoo import build_model

F32_TOL = dict(logits=(1e-4, 1e-4), cache=(1e-4, 1e-4))
BF16_TOL = dict(logits=(0.0, 1.5e-2), cache=(2.0 ** -6, 3e-2))
WIDE = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
            d_ff=512, vocab=1024)          # examples/serve_decode.py demo_cfg


def _configs(kind):
    if kind == "wide":
        return (dataclasses.replace(jax_get_config("llama3.2-1b"),
                                    dtype=jnp.float32, **WIDE),
                dataclasses.replace(get_config("llama3.2-1b"),
                                    dtype=torch.float32, **WIDE), F32_TOL)
    jcfg, tcfg = jax_smoke("llama3.2-1b"), serve_smoke_config("llama3.2-1b")
    if kind == "smoke_untied":
        return (dataclasses.replace(jcfg, tie_embeddings=False),
                dataclasses.replace(tcfg, tie_embeddings=False), F32_TOL)
    if kind == "smoke_bf16":
        return (dataclasses.replace(jcfg, dtype=jnp.bfloat16),
                dataclasses.replace(tcfg, dtype=torch.bfloat16), BF16_TOL)
    return jcfg, tcfg, F32_TOL


def _close(got, want, tol):
    rtol, atol = tol
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["smoke", "smoke_untied", "wide",
                                  "smoke_bf16"])
def test_prefill_and_decode_match_jax(kind):
    jcfg, tcfg, tol = _configs(kind)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    B, T, S = 2, 8, 16
    toks = rng.integers(0, tcfg.vocab, (B, T))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray([T] * B))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), torch.tensor([T] * B))
    _close(tl, jl, tol["logits"])
    for got, want in zip(tc["dense"], jc["dense"]):
        _close(got, want, tol["cache"])

    jcache = {"dense": tuple(f.at[:, :, :, :T].set(n) for f, n in
                             zip(jm.init_cache(B, S)["dense"], jc["dense"]))}
    tcache = tm.init_cache(B, S)
    for full, new in zip(tcache["dense"], tc["dense"]):
        full[:, :, :, :T] = new
    for t in range(4):
        # ragged rows: row 1 runs one position ahead of row 0; both only
        # write positions that were empty (there the reference's additive
        # cache write and the port's assignment agree)
        tok = rng.integers(0, tcfg.vocab, (B, 1))
        pos = np.array([[T + t], [T + 1 + t]])
        lens = pos[:, 0] + 1
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(lens))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos), torch.from_numpy(lens))
        _close(tl, jl, tol["logits"])
    for got, want in zip(tcache["dense"], jcache["dense"]):
        _close(got, want, tol["cache"])


def test_init_is_seeded_and_on_the_generator_device():
    cfg = serve_smoke_config("llama3.2-1b")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert a.embed.device.type == "cpu" and a.embed.dtype == torch.float32
    n = sum(p.numel() for p in a.parameters())
    # params_dense leaves the norm weights out: 2 per layer + ln_f
    assert n == cfg.params_dense + (2 * cfg.n_layers + 1) * cfg.d_model


def test_full_config_is_the_published_one():
    cfg = get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.tie_embeddings, cfg.dtype) == (
        16, 2048, 32, 8, 64, 8192, 128256, True, torch.bfloat16)
    jcfg = jax_get_config("llama3.2-1b")
    assert cfg.params_dense == jcfg.params_dense


@pytest.mark.parametrize("changes,match", [
    (dict(mtp=True), "MTP"), (dict(family="hybrid"), "zamba2"),
    (dict(moe=True), "MoE"), (dict(mla=True), "MLA"),
    (dict(family="audio", input_mode="embeddings"), "embedding inputs")])
def test_unported_families_raise(changes, match):
    cfg = dataclasses.replace(serve_smoke_config("llama3.2-1b"), **changes)
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, device="cpu")


def test_unported_config_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("zamba2-1.2b")
    with pytest.raises(KeyError):
        get_config("gpt-17")
    assert isinstance(get_config("llama3.2-1b"), ModelConfig)
