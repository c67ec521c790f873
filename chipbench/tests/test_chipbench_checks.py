"""The check that decides ``correct``: a sound CPU run passes it, a run
whose served tokens are altered where they are produced fails it, and
the control (the reference one precision below the configuration's
dtype) reads well above the program and fails the cell's limit."""
import copy

import pytest
import torch

from chipbench import harness, weights
from chipbench.drivers import serve
from chipbench.reference.plain import CONTROL, FLOAT32
from chipbench.tests.tiny import tiny_run

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


def _drive(name, monkeypatch=None, alter=False, freeze=False):
    run = tiny_run(name, seed=2**31 + 99, seconds=1.5)
    if freeze:
        from repro_torch.models.zoo import cache_tensors
        from repro_torch.serve.engine import Engine
        step = Engine.step

        def frozen(self):
            kept = [t.clone() for t in cache_tensors(self.caches)]
            out = step(self)
            for t, old in zip(cache_tensors(self.caches), kept):
                t.copy_(old)
            return out

        monkeypatch.setattr(Engine, "step", frozen)
    if alter:
        from repro_torch.serve.engine import Engine
        step = Engine.step

        def altered(self):
            live = {r.rid: r for r in self.slots if r is not None}
            out = step(self)
            vocab = run.cfg["model"]["vocab"]
            for rid, tok in out.items():
                if len(live[rid].out) == 3:   # each request's third token
                    out[rid] = live[rid].out[-1] = (tok + 1) % vocab
            return out

        monkeypatch.setattr(Engine, "step", altered)
    harness.driver(run.cell).run(run, 0.0)
    return run, harness.judge(run.checks)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_cpu_run_is_correct(name):
    run, ok = _drive(name)
    assert ok, run.checks
    assert run.checks["served_logit_gap"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_a_token_altered_where_produced_is_caught(name, monkeypatch):
    run, ok = _drive(name, monkeypatch, alter=True)
    assert not ok, run.checks


@pytest.mark.parametrize("name", CELLS)
def test_a_decode_step_that_leaves_its_state_unchanged_is_caught(
        name, monkeypatch):
    run, ok = _drive(name, monkeypatch, freeze=True)
    assert not ok, run.checks


def _medium(name):
    """A CPU size at which the control's rounding passes the cell's limit,
    as the configuration's family sets it (``medium``)."""
    cfg = copy.deepcopy(harness.config(name))
    return harness.reference(cfg).medium(cfg)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_the_program(name):
    """The program's widest served-token gap and its control's over the
    same 512 served tokens, each judged against the cell's limit as a run
    judges the program (the CPU stand-in for the chip's calibration,
    ``chipbench/calibrate.py``): the program passes, the control, put in
    its place, fails."""
    from repro_torch.models.zoo import build_model
    cell = harness.workload(name)
    cfg = _medium(cell["config"])
    mcfg = harness.model_config(cfg)
    model = build_model(mcfg, "cpu")
    params = harness.port_module(cfg)(mcfg, None, device="meta")
    specs = harness.reference(cfg).param_specs(cfg)
    weights.install(params, weights.draw(specs, 21, torch.device("cpu")))
    from repro_torch.serve.engine import Engine, Request
    engine = Engine(model, params, batch=1, max_len=704, device="cpu")
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, mcfg.vocab, (64,), generator=g).numpy()
    req = Request(rid=0, prompt=prompt, max_new=511)
    engine.admit(req)
    s = serve.Served(0, None, 0)
    s.req = type("R", (), {"prompt": prompt})()
    s.tokens = [int(engine.last_tok[0])]
    while not req.done:
        engine.step()
    s.tokens += req.out
    run = harness.Run(cell=cell, cfg=cfg, seed=21, seconds=0, trace=False,
                      device=torch.device("cpu"))
    from chipbench.drivers import common
    ref_w = common.reference_weights(run)
    control = CONTROL[cfg["model"]["dtype"]]
    got = serve.gaps(run, [s], ref_w, (FLOAT32, control))
    assert got[control.name] > 0 and \
        got[control.name] >= 3 * got["served"], got
    assert harness.judge(serve.judged(run, got["served"], 1)), got
    assert not harness.judge(serve.judged(run, got[control.name], 1)), got


CONFIGS = [c["name"] for c in harness.benchmark()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_weights_come_in_their_specs_dtype(name):
    """The check's weights are the seed's draw as it stands: every tensor
    in its spec's dtype and shape, equal to the program's, with no float32
    copy beside them."""
    from chipbench.drivers import common
    cfg = _medium(name)
    run = harness.Run(cell={}, cfg=cfg, seed=2**33 + 5, seconds=0,
                      trace=False, device=torch.device("cpu"))
    got = common.reference_weights(run)
    specs = harness.reference(cfg).param_specs(cfg)
    again = weights.draw(specs, run.seed, run.device)
    assert sorted(s.name for s in specs) == sorted(got)
    for s in specs:
        assert got[s.name].dtype == s.dtype, s.name
        assert tuple(got[s.name].shape) == s.shape, s.name
        assert torch.equal(got[s.name], again[s.name]), s.name
    assert any(s.dtype != torch.float32 for s in specs) == \
        (cfg["model"]["dtype"] != "float32")


@pytest.mark.parametrize("name", CELLS)
def test_gaps_read_the_same_on_weights_as_drawn_and_upcast(name):
    """The served gap and the control's, at the configuration's dtype,
    read bit for bit alike whether the reference is handed the weights as
    drawn or a float32 copy of them: upcasting is exact."""
    cell = harness.workload(name)
    cfg = _medium(cell["config"])
    run = harness.Run(cell=cell, cfg=cfg, seed=77, seconds=0, trace=False,
                      device=torch.device("cpu"))
    drawn = weights.draw(harness.reference(cfg).param_specs(cfg), 77,
                         run.device)
    g = torch.Generator().manual_seed(5)
    V = cfg["model"]["vocab"]
    s = serve.Served(0, None, 0)
    s.req = type("R", (), {"prompt": torch.randint(
        0, V, (24,), generator=g).numpy()})()
    s.tokens = torch.randint(0, V, (9,), generator=g).tolist()
    control = CONTROL[cfg["model"]["dtype"]]
    as_drawn = serve.gaps(run, [s], drawn, (FLOAT32, control))
    upcast = serve.gaps(run, [s], {n: t.float() for n, t in drawn.items()},
                        (FLOAT32, control))
    assert as_drawn == upcast
    assert as_drawn["served"] > 0


class _NoProfiler:
    """Stands in for ``trace.Profiler`` on the CPU: traces nothing."""

    def __init__(self, recorder):
        self.stretch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("trace", [False, True])
def test_the_programs_spans_are_on_in_traced_runs_alone(trace, monkeypatch):
    """A traced run turns the port's spans on in its window and again in
    the profiled stretch; it keeps each one's spans apart and turns them
    off again.  An untraced run turns none on and keeps none."""
    from repro_torch import spans
    monkeypatch.setattr(serve, "Profiler", _NoProfiler)
    monkeypatch.setattr(serve, "TRACE_SECONDS", 0.3)
    turned_on = []
    enable = spans.enable
    monkeypatch.setattr(spans, "enable",
                        lambda: turned_on.append(1) or enable())
    run = tiny_run(CELLS[-1], seed=2**31 + 5, seconds=0.5, trace=trace)
    harness.driver(run.cell).run(run, 0.0)
    assert not spans.ON and spans.take() == []
    assert harness.judge(run.checks), run.checks
    if not trace:
        assert not turned_on
        assert not hasattr(run, "program_spans")
        assert not hasattr(run, "window_program_spans")
        return
    assert turned_on == [1, 1]
    w0, w1 = run.window
    for got, lo, hi in ((run.window_program_spans, w0, w1),
                        (run.program_spans, w1, float("inf"))):
        names = {s.name for s in got}
        assert {"engine.step", "model.decode",
                "engine.step.readback"} <= names
        assert all(lo <= s.t0 and 0 < s.t1 <= hi for s in got)
