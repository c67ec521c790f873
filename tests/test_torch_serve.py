"""Port's serving engine and traffic harness against the JAX reference:
identical greedy tokens on fresh slots, a byte-identical traffic report,
a recycled slot that decodes like a fresh one (llama, zamba2 and
deepseek-v3), admission placing every cache layout, and entry points
that refuse to fall back to the CPU unasked."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.traffic import FixedLatencyModel as JaxFixedLatency
from repro.serve.traffic import TrafficConfig as JaxTraffic
from repro.serve.traffic import report_json as jax_report_json
from repro.serve.traffic import run_traffic as jax_run_traffic
from repro_torch.configs.registry import serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.zoo import build_model, cache_tensors
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.traffic import (FixedLatencyModel, TrafficConfig,
                                       report_bench_rows, report_json,
                                       run_traffic)

CFG = serve_smoke_config("llama3.2-1b")


@pytest.fixture(scope="module")
def both():
    jm = jax_build(jax_smoke("llama3.2-1b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(CFG, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return (jm, jp), (tm, tp)


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, size=(int(rng.integers(lo, hi)),))
            for _ in range(n)]


def _serve(eng, make_req, prompts, max_new):
    reqs = [make_req(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.admit(r)
    while any(not r.done for r in reqs):
        eng.step()
    return [r.out for r in reqs]


def test_engine_tokens_match_jax_on_fresh_slots(both):
    (jm, jp), (tm, tp) = both
    prompts = _prompts(3, 4, 12)
    want = _serve(JaxEngine(jm, jp, batch=4, max_len=64), JaxRequest,
                  prompts, max_new=8)
    got = _serve(Engine(tm, tp, batch=4, max_len=64, device="cpu"), Request,
                 prompts, max_new=8)
    assert got == want


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
    assert got["truncated"] > 0 and got["slot_occupancy"]["max"] == 1.0
    assert report_bench_rows(got)[0]["derived"]["served"] == 8


def test_recycled_slot_decodes_like_a_fresh_one(both):
    _, (tm, tp) = both
    first, second = _prompts(2, 10, 14, seed=5)
    fresh = _serve(Engine(tm, tp, batch=1, max_len=32, device="cpu"),
                   Request, [second], max_new=12)
    eng = Engine(tm, tp, batch=1, max_len=32, device="cpu")
    _serve(eng, Request, [first], max_new=12)     # leaves K/V past len(second)
    assert _serve(eng, Request, [second], max_new=12) == fresh


def test_admit_rejects_or_truncates_overlong_prompts(both):
    _, (tm, tp) = both
    eng = Engine(tm, tp, batch=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len=8"):
        eng.admit(Request(rid=0, prompt=np.arange(9), max_new=2))
    req = Request(rid=1, prompt=np.arange(9), max_new=2)
    assert eng.admit(req, truncate=True) and req.truncated
    assert list(req.prompt) == list(range(2, 9))
    assert not eng.admit(Request(rid=2, prompt=np.arange(3), max_new=2))


def test_entry_points_need_a_device_without_cuda(both, monkeypatch):
    _, (tm, tp) = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tm, tp, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, CFG)


def test_engine_rejects_a_model_on_another_device(both):
    _, (tm, tp) = both
    with pytest.raises(ValueError, match="model is on cpu"):
        Engine(tm, tp, batch=1, max_len=8, device="meta")


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b", "deepseek-v3-671b"])
def test_admission_places_latents_and_hybrid_state(arch_id):
    """The engine's merge rule on the new cache layouts: MLA latents (n,
    B, S, r) and the hybrid's shared-block K/V get the prompt's rows [0,
    plen) of their slot; the hybrid's conv and SSM states, which have no
    sequence axis, are overwritten whole.  Other slots stay as they
    were."""
    cfg = serve_smoke_config(arch_id)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, batch=3, max_len=32, device="cpu")
    for c in cache_tensors(eng.caches):          # a used engine's leftovers
        c.copy_(torch.randn(c.shape, generator=torch.Generator()
                            .manual_seed(c.ndim)))
    before = [c.clone() for c in cache_tensors(eng.caches)]
    eng.slots[0] = Request(rid=-1, prompt=np.arange(3), max_new=1)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (9,))
    assert eng.admit(Request(rid=0, prompt=prompt, max_new=2))
    _, pre = model.prefill(params, torch.from_numpy(prompt[None]),
                           torch.tensor([9]))
    seq_axes = []
    for full, new, old in zip(cache_tensors(eng.caches),
                              cache_tensors(pre), before):
        assert new.shape[1] == 1
        seq = [ax for ax in range(2, new.ndim)
               if new.shape[ax] != full.shape[ax]]
        seq_axes.append(seq)
        rows = [slice(None)] * new.ndim
        rows[1] = 1
        if seq:
            rows[seq[0]] = slice(0, 9)
        assert torch.equal(full[tuple(rows)], new[:, 0])
        if seq:         # past the prompt, slot 1 keeps its old rows
            rows[seq[0]] = slice(9, None)
            assert torch.equal(full[tuple(rows)], old[tuple(rows)])
        for other in (0, 2):
            assert torch.equal(full[:, other], old[:, other])
    want = [[2], [2]] if cfg.mla else [[], [], [3], [3]]
    assert seq_axes == want


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b", "deepseek-v3-671b"])
def test_new_family_recycled_slot_decodes_like_a_fresh_one(arch_id):
    cfg = serve_smoke_config(arch_id)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    first, second = (rng.integers(0, cfg.vocab, size=(n,)) for n in (14, 10))
    fresh = _serve(Engine(model, params, batch=1, max_len=32, device="cpu"),
                   Request, [second], max_new=12)
    eng = Engine(model, params, batch=1, max_len=32, device="cpu")
    _serve(eng, Request, [first], max_new=12)    # leaves state and K/V
    assert _serve(eng, Request, [second], max_new=12) == fresh
