"""The port's fleet (``repro_torch.dist``): the supervised runner's
parallel result equals the sequential one, killed workers, stragglers,
an exhausted retry budget and a silent group are recovered from (or
raise) as in the JAX package, fault plans round-trip and equal the
reference's, the elastic bookkeeping answers as the reference's, a
faulted compile fan-out gives the sequential artifacts, and
``sharding`` resolves lazily without loading torch."""
import json
import os
import subprocess
import sys
import warnings

import pytest

from repro_torch.core import pool
from repro_torch.dist import elastic, faults
from repro_torch.dist.fleet import (DEFAULT_RETRIES, DEFAULT_TIMEOUT_S,
                                    FleetConfig, FleetError,
                                    backoff_schedule, run_fleet)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture
def needs_pool():
    if pool.shared_pool() is None:
        pytest.skip("process fan-out unavailable in this context")


def test_backoff_and_config_match_the_reference(monkeypatch):
    from repro.dist import fleet as ref_fleet
    for args in ((4,), (0,), (8, 0.2, 1.0)):
        assert backoff_schedule(*args) == ref_fleet.backoff_schedule(*args)
    assert backoff_schedule(8, base_s=0.2, cap_s=1.0)[3:] == (1.0,) * 5
    monkeypatch.delenv("MORPHER_TASK_TIMEOUT_S", raising=False)
    monkeypatch.delenv("MORPHER_FLEET_RETRIES", raising=False)
    cfg = FleetConfig()
    assert (cfg.resolved_timeout_s(), cfg.resolved_retries()) == \
        (DEFAULT_TIMEOUT_S, DEFAULT_RETRIES) == \
        (ref_fleet.DEFAULT_TIMEOUT_S, ref_fleet.DEFAULT_RETRIES)
    monkeypatch.setenv("MORPHER_TASK_TIMEOUT_S", "7.5")
    monkeypatch.setenv("MORPHER_FLEET_RETRIES", "5")
    assert (cfg.resolved_timeout_s(), cfg.resolved_retries()) == (7.5, 5)
    explicit = FleetConfig(timeout_s=1.0, retries=0, heartbeat_timeout_s=3.0)
    assert (explicit.resolved_timeout_s(), explicit.resolved_retries(),
            explicit.resolved_heartbeat_s(1.0)) == (1.0, 0, 3.0)


def test_fault_plans_roundtrip_and_equal_the_references(tmp_path):
    from repro.dist import faults as ref_faults
    kw = dict(seed=3, units=10, kills=2, delays=1, mutes=1, groups=4)
    p = faults.FaultPlan.seeded(**kw)
    r = ref_faults.FaultPlan.seeded(**kw)
    assert (p.kill_units, p.delay_units, p.mute_groups) == \
        (r.kill_units, r.delay_units, r.mute_groups)
    assert faults.FaultPlan.from_json(p.to_json()) == p
    assert json.loads(p.to_json()).keys() == json.loads(r.to_json()).keys()
    plan = faults.FaultPlan(kill_units=(1,), state_dir=str(tmp_path)).armed()
    assert plan._fire_once("kill-1") is True
    assert plan._fire_once("kill-1") is False    # exactly once per tag
    a, b = tmp_path / "a", tmp_path / "b"
    payload = json.dumps({"k": list(range(40))}).encode()
    a.write_bytes(payload)
    b.write_bytes(payload)
    faults.corrupt_file(str(a), seed=7)
    ref_faults.corrupt_file(str(b), seed=7)
    assert a.read_bytes() == b.read_bytes() != payload


def test_fleet_inline_fallback_and_empty_payloads(monkeypatch):
    assert run_fleet(faults.double, []).results == []
    monkeypatch.setenv(pool.WORKER_ENV, "1")
    plan = faults.FaultPlan(kill_units=(0, 1, 2)).armed()
    rep = run_fleet(faults.double, [1, 2, 3],
                    FleetConfig(groups=2, faults=plan))
    assert rep.results == [2, 4, 6]
    assert rep.sequential and not rep.quiet()
    rep = run_fleet(faults.double, [1, 2, 3], FleetConfig(groups=2),
                    inline_fallback=False)
    assert rep.results is None and rep.sequential


def test_fleet_parallel_matches_sequential(needs_pool):
    rep = run_fleet(faults.double, list(range(8)),
                    FleetConfig(groups=2, timeout_s=60))
    assert rep.results == [p * 2 for p in range(8)]
    assert not rep.sequential and rep.quiet()


def test_fleet_recovers_from_killed_worker(needs_pool):
    plan = faults.FaultPlan(kill_units=(1,)).armed()
    rep = run_fleet(faults.double, list(range(8)),
                    FleetConfig(groups=2, timeout_s=60, faults=plan))
    assert rep.results == [p * 2 for p in range(8)]
    assert rep.pool_rebuilds >= 1
    assert pool.process_map(faults.double, [1, 2, 3]) in ([2, 4, 6], None)


def test_fleet_straggler_times_out_and_result_survives(needs_pool):
    plan = faults.FaultPlan(delay_units=((2, 1.5),)).armed()
    rep = run_fleet(faults.double, list(range(8)),
                    FleetConfig(groups=2, timeout_s=0.4, retries=2,
                                faults=plan))
    assert rep.results == [p * 2 for p in range(8)]
    assert {"unit": 2, "attempt": 0} in rep.timeouts
    assert rep.retries >= 1


def test_fleet_exhausted_retry_budget_raises(needs_pool):
    plan = faults.FaultPlan(delay_units=((0, 1.0), (1, 1.0), (2, 1.0),
                                         (3, 1.0))).armed()
    with pytest.raises(FleetError):
        run_fleet(faults.double, list(range(4)),
                  FleetConfig(groups=2, timeout_s=0.3, retries=0,
                              faults=plan))
    pool.reset_pool(kill=True)


def test_fleet_evicts_silent_group_and_steals_exactly_once(needs_pool):
    plan = faults.FaultPlan(delay_units=((1, 1.2),),
                            mute_groups=(1,)).armed()
    rep = run_fleet(faults.double, list(range(6)),
                    FleetConfig(groups=2, timeout_s=30,
                                heartbeat_timeout_s=0.4, max_inflight=2,
                                faults=plan))
    assert rep.results == [p * 2 for p in range(6)]
    assert rep.evicted_groups == [1]
    assert rep.stolen_units == [3, 5]


def test_process_map_survives_killed_worker(needs_pool):
    assert pool.process_map(faults.kill_worker, [1, 2, 3]) is None
    assert pool.process_map(faults.double, [1, 2, 3]) == [2, 4, 6]


def test_faulted_compile_fanout_gives_the_sequential_artifacts(needs_pool):
    """A killed compile worker and a straggler past its deadline: the
    fan-out recovers and its artifacts are the sequential compile's byte
    for byte (results only: the recovery ledger is not pinned)."""
    from repro_torch.core import Toolchain, build_gemm
    from repro_torch.frontend.library import dsl_kernels
    specs = [build_gemm(TI=4, TK=4, TJ=4, unroll=1),
             dsl_kernels()["requant-int8"], dsl_kernels()["avgpool2x2"]]
    want = [ck.to_json()
            for ck in Toolchain(cache_dir="").compile_many(specs, jobs=1)]
    plan = faults.FaultPlan(kill_units=(1,),
                            delay_units=((2, 6.0),)).armed()
    tc = Toolchain(cache_dir="")
    got = tc.compile_many(specs, fleet=FleetConfig(
        groups=2, timeout_s=3.0, faults=plan))
    assert [ck.to_json() for ck in got] == want


def test_checkpoint_failures_warn_once(tmp_path):
    from repro_torch.dse import explore
    blocker = tmp_path / "blocker"
    blocker.write_text("a file, not a directory")
    bad = str(blocker / "sub" / "ckpt.json")
    with pytest.warns(RuntimeWarning, match="NOT being saved"):
        explore._store_checkpoint(bad, {"v": 1}, {})
    fp = {"schema": 1}
    path = tmp_path / "ckpt.json"
    path.write_text(json.dumps({"fingerprint": fp, "variants": {}}))
    assert explore._load_checkpoint(str(path), fp) == {}
    faults.corrupt_file(str(path), seed=0, n_bytes=16)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert explore._load_checkpoint(str(path), fp) == {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        explore._store_checkpoint(bad, {"v": 1}, {})
        assert explore._load_checkpoint(str(path), fp) == {}


def test_elastic_answers_as_the_reference():
    from repro.dist import elastic as ref
    for n in (512, 496, 500, 13, 1, 64):
        for mp in (16, 8, 1):
            assert elastic.best_mesh_shape(n, mp) == \
                ref.best_mesh_shape(n, mp)
    for steps, req in (([100, 200, 300], None), ([100, 200, 300], 250),
                       ([], None), ([7], 3)):
        assert elastic.resume_plan(steps, requested_step=req) == \
            ref.resume_plan(steps, requested_step=req)
    hb, rhb = elastic.HeartbeatMonitor(timeout_s=10), \
        ref.HeartbeatMonitor(timeout_s=10)
    for m in (hb, rhb):
        m.beat(0, now=100.0)
        m.beat(1, now=112.0)
    for now in (105.0, 111.0, 120.0, 125.0):
        assert hb.dead_hosts(now=now) == rhb.dead_hosts(now=now)
        assert hb.all_alive(2, now=now) == rhb.all_alive(2, now=now)


def test_sharding_resolves_without_loading_torch():
    """``import repro_torch.dist`` loads no torch, and ``dist.sharding``
    resolves lazily (its specs need no torch either)."""
    code = ("import sys; import repro_torch.dist as d; "
            "assert 'torch' not in sys.modules; "
            "s = d.sharding; assert 'sharding' in dir(d); "
            "assert s.param_spec((4096, 13440), type('M', (), {"
            "'axis_names': ('data', 'model'), 'devices': "
            "__import__('numpy').empty((16, 16))})()) == ('data', 'model'); "
            "assert 'torch' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
