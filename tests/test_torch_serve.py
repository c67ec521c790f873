"""Port's serving engine and traffic harness against the JAX reference:
identical greedy tokens on fresh slots, a byte-identical traffic report,
a recycled slot that decodes like a fresh one, and entry points that
refuse to fall back to the CPU unasked."""
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
from repro_torch.models.zoo import build_model
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
