"""Port's models against the JAX reference on the CPU: the JAX model's
own parameters go through params_from_jax, then prefill logits, prefill
caches and chained decode steps are compared (llama3.2-1b in several
forms; llama3.2-3b, codeqwen1.5-7b and granite-34b at narrow width, with
the engine's greedy tokens too; zamba2, llama4-maverick, deepseek-v3 with
its MTP head, musicgen-large and llava-next at serve_smoke_config size).

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
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.models.transformer import mtp_logits as jax_mtp_logits
from repro.models.transformer import transformer_apply as jax_apply
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          serve_smoke_config)
from repro_torch.convert import params_from_jax
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import transformer_apply
from repro_torch.models.zoo import build_model, cache_tensors
from repro_torch.serve.engine import Engine, Request

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


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_every_config_builds(arch_id):
    """Every config loads and builds (no family is refused); an unknown
    id raises KeyError."""
    cfg = get_config(arch_id)
    assert isinstance(cfg, ModelConfig)
    model = build_model(cfg, device="cpu")
    assert model.cfg is cfg and (model.mtp_logits is not None) == cfg.mtp
    with pytest.raises(KeyError):
        get_config("gpt-17")


# The dense configs at narrow width: each keeps its query / KV head ratio
# (G 3, 1 and 48) and its own head (tied for llama3.2-3b, untied for the
# others), with head_dim 16 != d_model / n_heads.
DENSE_NARROW = {"llama3.2-3b": (6, 2), "codeqwen1.5-7b": (4, 4),
                "granite-34b": (48, 1)}


@pytest.mark.parametrize("arch_id", sorted(DENSE_NARROW))
def test_dense_config_matches_jax_at_narrow_width(arch_id):
    H, Hkv = DENSE_NARROW[arch_id]
    narrow = dict(n_layers=2, d_model=64, n_heads=H, n_kv_heads=Hkv,
                  head_dim=16, d_ff=128, vocab=256)
    jcfg = dataclasses.replace(jax_get_config(arch_id), dtype=jnp.float32,
                               **narrow)
    tcfg = dataclasses.replace(get_config(arch_id), dtype=torch.float32,
                               **narrow)
    assert tcfg.tie_embeddings == (arch_id == "llama3.2-3b")
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    B, T, S = 2, 8, 16
    toks = rng.integers(0, tcfg.vocab, (B, T))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray([T] * B))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), torch.tensor([T] * B))
    _close(tl, jl, F32_TOL["logits"])
    jcache = {"dense": tuple(f.at[:, :, :, :T].set(n) for f, n in
                             zip(jm.init_cache(B, S)["dense"], jc["dense"]))}
    tcache = tm.init_cache(B, S)
    for full, new in zip(tcache["dense"], tc["dense"]):
        full[:, :, :, :T] = new
    for t in range(3):
        tok = rng.integers(0, tcfg.vocab, (B, 1))
        pos = np.array([[T + t], [T + 1 + t]])
        lens = pos[:, 0] + 1
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(lens))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos), torch.from_numpy(lens))
        _close(tl, jl, F32_TOL["logits"])

    def serve(eng, make_req):
        prompts = np.random.default_rng(2)
        reqs = [make_req(rid=i, prompt=prompts.integers(
                    0, tcfg.vocab, size=(int(prompts.integers(4, 12)),)),
                         max_new=8) for i in range(3)]
        for r in reqs:
            assert eng.admit(r)
        while any(not r.done for r in reqs):
            eng.step()
        return [r.out for r in reqs]

    assert serve(Engine(tm, tp, batch=4, max_len=32, device="cpu"),
                 Request) == serve(JaxEngine(jm, jp, batch=4, max_len=32),
                                   JaxRequest)


# The families of PR 20 at serve_smoke_config size (float32).
NEW_FAMILIES = ("zamba2-1.2b", "llama4-maverick-400b-a17b",
                "deepseek-v3-671b", "musicgen-large",
                "llava-next-mistral-7b")


def _both(arch_id):
    jcfg, tcfg = jax_smoke(arch_id), serve_smoke_config(arch_id)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return tcfg, (jm, jp), (tm, tp)


def _inputs(rng, cfg, B, T):
    """Token ids, or N(0, 1) embeddings for an embeddings-input config."""
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, (B, T))
    return rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)


def _seq_index(full_shape, new_shape):
    """The engine's merge rule for a whole batch: a sequence axis only
    where the prefill's shape differs from the cache's."""
    idx = [slice(None)] * len(new_shape)
    for ax in range(2, len(new_shape)):
        if new_shape[ax] != full_shape[ax]:
            idx[ax] = slice(0, new_shape[ax])
            break
    return tuple(idx)


def _close_tree(got, want, tol):
    want = jax.tree.leaves(want)
    got = cache_tensors(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("arch_id", NEW_FAMILIES)
def test_new_family_prefill_and_decode_match_jax(arch_id):
    """Prefill logits and every cache tensor, then 3 chained decode steps
    (ragged rows, each writing only positions that were empty) and the
    caches after them."""
    cfg, (jm, jp), (tm, tp) = _both(arch_id)
    rng = np.random.default_rng(0)
    B, T, S = 2, 8, 16
    x = _inputs(rng, cfg, B, T)
    jl, jc = jm.prefill(jp, jnp.asarray(x), jnp.asarray([T] * B))
    tl, tc = tm.prefill(tp, torch.from_numpy(x), torch.tensor([T] * B))
    _close(tl, jl, F32_TOL["logits"])
    _close_tree(tc, jc, F32_TOL["cache"])

    jcache = jax.tree.map(lambda f, n: f.at[_seq_index(f.shape, n.shape)]
                          .set(n), jm.init_cache(B, S), jc)
    tcache = tm.init_cache(B, S)
    for full, new in zip(cache_tensors(tcache), cache_tensors(tc)):
        full[_seq_index(full.shape, new.shape)] = new
    for t in range(3):
        step = _inputs(rng, cfg, B, 1)
        pos = np.array([[T + t], [T + 1 + t]])
        lens = pos[:, 0] + 1
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(step),
                               jnp.asarray(pos), jnp.asarray(lens))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(step),
                               torch.from_numpy(pos), torch.from_numpy(lens))
        _close(tl, jl, F32_TOL["logits"])
    _close_tree(tcache, jcache, F32_TOL["cache"])


def test_mtp_logits_match_jax():
    cfg, (jm, jp), (tm, tp) = _both("deepseek-v3-671b")
    assert tm.mtp_logits is not None
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 9))
    pos = np.broadcast_to(np.arange(9), (2, 9))
    jh, _c, _a = jax_apply(jp, jm.cfg, jnp.asarray(toks), jnp.asarray(pos))
    want = jax_mtp_logits(jp, jm.cfg, jh, jnp.asarray(toks))
    th, _ = transformer_apply(tp, cfg, torch.from_numpy(toks),
                              torch.from_numpy(pos.copy()))
    _close(th, jh, F32_TOL["logits"])
    got = tm.mtp_logits(tp, th, torch.from_numpy(toks))
    assert got.shape == (2, 8, cfg.vocab)
    _close(got, want, F32_TOL["logits"])


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b",
                                     "llama4-maverick-400b-a17b",
                                     "deepseek-v3-671b"])
def test_new_family_engine_tokens_match_jax(arch_id):
    """Greedy tokens of both engines on fresh slots.  Every slot holds a
    request for the whole run: the reference's decode adds K/V into an
    idle slot's position 0 step after step (ROADMAP C3), and through the
    experts' shared capacity an idle row's routing can move the others'."""
    cfg, (jm, jp), (tm, tp) = _both(arch_id)

    def serve(eng, make_req):
        prompts = np.random.default_rng(2)
        reqs = [make_req(rid=i, prompt=prompts.integers(
                    0, cfg.vocab, size=(int(prompts.integers(4, 12)),)),
                         max_new=8) for i in range(3)]
        for r in reqs:
            assert eng.admit(r)
        while any(not r.done for r in reqs):
            eng.step()
        return [r.out for r in reqs]

    got = serve(Engine(tm, tp, batch=3, max_len=32, device="cpu"), Request)
    assert got == serve(JaxEngine(jm, jp, batch=3, max_len=32), JaxRequest)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_parameter_count_equals_jax(arch_id):
    """The port's parameters hold as many elements as the JAX tree, leaf
    for leaf by name (params_from_jax refuses a leaf it cannot place)."""
    cfg, (jm, jp), (_, tp) = _both(arch_id)
    jax_n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == jax_n
    fresh = build_model(cfg, device="cpu").init(torch.Generator()
                                                .manual_seed(0))
    assert sum(p.numel() for p in fresh.parameters()) == jax_n
