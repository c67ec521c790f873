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
    """A CPU size at which the control's rounding passes the cell's limit:
    the full vocabulary, the configuration's dtype, narrower and (zamba2)
    shallower: rwkv6 24 layers of width 512, zamba2 12 of width 256."""
    cfg = copy.deepcopy(harness.config(name))
    m = cfg["model"]
    if cfg["family"] == "rwkv6":
        m.update(d_model=512, n_heads=8, n_kv_heads=8, d_ff=1792,
                 head_dim=64)
        cfg["derived"].update(head_size=64, decay_lora_rank=32)
    else:
        m.update(n_layers=12, d_model=256, n_heads=4, n_kv_heads=4,
                 d_ff=512, head_dim=64, attn_every=3)
        cfg["derived"].update(d_inner=512, mamba_heads=4,
                              mamba_head_dim=128, shared_applications=4)
    return cfg


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
