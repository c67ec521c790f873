"""Port's rwkv6 model and serving engine against the JAX reference on the
CPU: the JAX model's own parameters go through params_from_jax, then
prefill logits, the three state tensors and four chained decode steps are
compared, and both engines serve the same requests over recycled slots.

Tolerances: 1e-4 (rtol and atol) in float32, on the smoke config and on
a wider one (4 layers, d_model 256, 8 heads; measured at most 5.9e-5 on
wkv states of magnitude up to 35).  In bfloat16 the two frameworks round
matmul sums at other places; measured on the smoke config over seeds 0-2
the logits and the token-shift states differ by at most 2.7e-2 absolute
and the wkv states by at most 1.3e-1 at magnitudes up to 25, so bf16 is
held to 5e-2 absolute on logits and token-shift states, and to 2^-6
relative + 5e-2 absolute on the wkv states."""
import dataclasses
from collections import deque

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
from repro.serve.traffic import FixedLatencyModel as JaxFixedLatency
from repro.serve.traffic import TrafficConfig as JaxTraffic
from repro.serve.traffic import report_json as jax_report_json
from repro.serve.traffic import run_traffic as jax_run_traffic
from repro_torch.configs.registry import get_config, serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.traffic import (FixedLatencyModel, TrafficConfig,
                                       report_json, run_traffic)

ARCH = "rwkv6-1.6b"
CFG = serve_smoke_config(ARCH)
F32 = dict(logits=(1e-4, 1e-4), shift=(1e-4, 1e-4), wkv=(1e-4, 1e-4))
BF16 = dict(logits=(0.0, 5e-2), shift=(0.0, 5e-2), wkv=(2.0 ** -6, 5e-2))
WIDE = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
            d_ff=512, vocab=1024)


def _configs(kind):
    if kind == "wide":
        return (dataclasses.replace(jax_get_config(ARCH), dtype=jnp.float32,
                                    **WIDE),
                dataclasses.replace(get_config(ARCH), dtype=torch.float32,
                                    **WIDE), F32)
    if kind == "smoke_bf16":
        return (dataclasses.replace(jax_smoke(ARCH), dtype=jnp.bfloat16),
                dataclasses.replace(CFG, dtype=torch.bfloat16), BF16)
    return jax_smoke(ARCH), CFG, F32


def _close(got, want, tol):
    rtol, atol = tol
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _close_states(got, want, tol):
    for g, w, key in zip(got, want, ("shift", "wkv", "shift")):
        assert g.shape == w.shape
        _close(g, w, tol[key])


@pytest.mark.parametrize("kind", ["smoke", "wide", "smoke_bf16"])
def test_prefill_and_decode_match_jax(kind):
    jcfg, tcfg, tol = _configs(kind)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    B, T = 2, 8
    toks = rng.integers(0, tcfg.vocab, (B, T))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray([T] * B))
    tl, ts = tm.prefill(tp, torch.from_numpy(toks), torch.tensor([T] * B))
    _close(tl, jl, tol["logits"])
    _close_states(ts, js, tol)
    assert ts[1].dtype == torch.float32 and ts[0].dtype == tcfg.dtype

    for t in range(4):
        tok = rng.integers(0, tcfg.vocab, (B, 1))
        pos = np.full((B, 1), T + t)
        jl, js = jm.decode(jp, js, jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(pos[:, 0] + 1))
        before = ts
        tl, ts = tm.decode(tp, ts, torch.from_numpy(tok),
                           torch.from_numpy(pos),
                           torch.from_numpy(pos[:, 0] + 1))
        assert all(a is b for a, b in zip(ts, before))   # written in place
        _close(tl, jl, tol["logits"])
    _close_states(ts, js, tol)


def test_init_is_seeded_with_the_reference_shapes_and_dtypes():
    model = build_model(CFG, device="cpu")
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    jp = jax_build(dataclasses.replace(jax_smoke(ARCH), dtype=jnp.bfloat16)
                   ).init(jax.random.PRNGKey(0))
    tp = build_model(dataclasses.replace(CFG, dtype=torch.bfloat16),
                     device="cpu").init(torch.Generator().manual_seed(0))
    for name in ("embed", "ln_f", "head"):
        got = getattr(tp, name)
        assert tuple(got.shape) == jp[name].shape, name
        assert str(got.dtype)[6:] == jp[name].dtype.name, name
    for name, want in jp["layers"].items():
        got = getattr(tp.layers[0], name)
        assert (CFG.n_layers, *got.shape) == want.shape, name
        assert str(got.dtype)[6:] == want.dtype.name, name


def _serve_queue(eng, make_req, prompts, max_new):
    """Admit while a slot is free, then step, until every request is
    done; more requests than slots, so slots are recycled."""
    reqs = [make_req(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    pending = deque(reqs)
    while pending or eng.n_active:
        while pending and eng.has_free_slot():
            assert eng.admit(pending.popleft())
        eng.step()
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def both():
    jm = jax_build(jax_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(CFG, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return (jm, jp), (tm, tp)


def test_engine_tokens_match_jax_with_recycled_slots(both):
    (jm, jp), (tm, tp) = both
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab, size=int(rng.integers(3, 14)))
               for _ in range(5)]
    max_new = [6, 3, 8, 5, 4]
    want = _serve_queue(JaxEngine(jm, jp, batch=2, max_len=32), JaxRequest,
                        prompts, max_new)
    eng = Engine(tm, tp, batch=2, max_len=32, device="cpu")
    got = _serve_queue(eng, Request, prompts, max_new)
    assert got == want
    assert [len(o) for o in got] == max_new


def test_traffic_report_byte_identical_to_jax(both):
    (jm, jp), (tm, tp) = both
    kw = dict(seed=3, n_requests=8, arrival_rate=400.0, prompt_len=(4, 20),
              max_new=(2, 6))
    want = jax_run_traffic(
        JaxEngine(jm, jp, batch=2, max_len=16,
                  exec_model=JaxFixedLatency()),
        JaxTraffic(**kw), CFG.vocab)
    got = run_traffic(
        Engine(tm, tp, batch=2, max_len=16, exec_model=FixedLatencyModel(),
               device="cpu"),
        TrafficConfig(**kw), CFG.vocab)
    assert report_json(got) == jax_report_json(want)
    assert got["truncated"] > 0


def test_full_config_is_the_published_one():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.d_model // cfg.n_heads, cfg.d_ff, cfg.vocab,
            cfg.tie_embeddings, cfg.dtype) == (
        "ssm", 24, 2048, 32, 64, 7168, 65536, False, torch.bfloat16)
    assert cfg.params_dense == jax_get_config(ARCH).params_dense


def test_full_model_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config(ARCH))
