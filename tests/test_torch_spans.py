"""The port's spans (``repro_torch.spans``) over one admission and one
decode step of tiny rwkv6 and zamba2 models: they nest as the engine and
the models call each other, carry their counts, are recorded only while
on, change no token, logit or cache, and share the benchmark's clock."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.registry import serve_smoke_config
from repro_torch.models.zoo import build_model, cache_tensors
from repro_torch.serve.engine import Engine, Request

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))

ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
PROMPT = 9


def _blocks(arch, parent):
    """(name, parent, meta) of the block spans and the head, in order."""
    if arch == "rwkv6-1.6b":      # 2 layers
        names = [("block.rwkv6", 0), ("block.rwkv6", 1)]
    else:                         # 4 Mamba2 layers, the shared block after
        names = [("block.mamba2", 0), ("block.mamba2", 1),     # every 2nd
                 ("block.shared_attn", 0), ("block.mamba2", 2),
                 ("block.mamba2", 3), ("block.shared_attn", 1)]
    return [(n, parent, {"layer": i}) for n, i in names] + \
        [("model.head", parent, {})]


def _expected(arch):
    admit = [("engine.admit", None, {"rid": 7, "tokens": PROMPT}),
             ("model.prefill", 0, {"tokens": PROMPT})]
    admit += _blocks(arch, 1)
    admit += [("engine.admit.merge", 0, {}),
              ("engine.admit.readback", 0, {})]
    s = len(admit)
    step = [("engine.step", None, {"active": 1, "batch": 2}),
            ("engine.step.inputs", s, {}),
            ("model.decode", s, {})]
    step += _blocks(arch, s + 2)
    step += [("engine.step.readback", s, {}),
             ("engine.step.finish", s, {})]
    return admit + step


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = serve_smoke_config(request.param)
    m = build_model(cfg, device="cpu")
    return request.param, m, m.init(torch.Generator().manual_seed(0))


def _admit_and_step(m, params):
    eng = Engine(m, params, batch=2, max_len=32, device="cpu")
    prompt = np.random.default_rng(0).integers(0, m.cfg.vocab, size=PROMPT)
    assert eng.admit(Request(rid=7, prompt=prompt, max_new=4))
    return eng, eng.step()


def test_spans_nest_as_the_engine_and_model_call(model):
    arch, m, params = model
    spans.enable()
    _admit_and_step(m, params)
    got = spans.take()
    assert [(s.name, s.parent, s.meta) for s in got] == _expected(arch)
    for i, s in enumerate(got):
        assert 0 < s.t0 <= s.t1
        if i:
            assert got[i - 1].t0 <= s.t0
        if s.parent is not None:
            p = got[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    assert spans.take() == []


def test_nothing_is_recorded_while_off(model):
    _arch, m, params = model
    _admit_and_step(m, params)
    assert spans.take() == []
    spans.enable()
    spans.disable()
    _admit_and_step(m, params)
    assert spans.take() == []


def test_recording_changes_no_token_logit_or_cache(model):
    _arch, m, params = model
    runs = []
    for on in (False, True):
        if on:
            spans.enable()
        eng, out = _admit_and_step(m, params)
        toks = torch.tensor([[3], [5]])
        pos = torch.tensor([[PROMPT + 1], [0]])
        lens = torch.tensor([PROMPT + 2, 1])
        logits, caches = m.decode(params, eng.caches, toks, pos, lens)
        pre, _ = m.prefill(params, toks[:1].expand(1, 4), torch.tensor([4]))
        spans.disable()
        runs.append((int(eng.last_tok[0]), out, logits, pre,
                     cache_tensors(caches)))
    (t0, o0, l0, p0, c0), (t1, o1, l1, p1, c1) = runs
    assert (t0, o0) == (t1, o1)
    assert torch.equal(l0, l1) and torch.equal(p0, p1)
    assert len(c0) == len(c1)
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))


def test_spans_share_the_benchmarks_clock(model):
    """A span of ``chipbench.trace.Recorder`` opened around ``step``
    holds every span the step records."""
    from chipbench.trace import Recorder
    _arch, m, params = model
    eng, _ = _admit_and_step(m, params)
    rec = Recorder()
    spans.enable()
    outer = rec.open("decode_step")
    eng.step()
    rec.close(outer)
    got = spans.take()
    assert got[0].name == "engine.step"
    assert all(outer.t0 <= s.t0 <= s.t1 <= outer.t1 for s in got)


def test_a_raising_block_closes_its_span_and_its_parents():
    spans.enable()
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner", k=1):
                raise ValueError
    with spans.span("after"):
        pass
    outer, inner, after = spans.take()
    assert (inner.parent, inner.meta, after.parent) == (0, {"k": 1}, None)
    assert outer.t1 >= inner.t1 > 0 and after.t0 >= outer.t1


def test_take_inside_a_span_leaves_no_dangling_parent():
    spans.enable()
    with spans.span("outer") as outer:
        assert spans.take() == [outer]
        with spans.span("inner"):
            pass
    assert outer.t1 >= outer.t0
    (inner,) = spans.take()
    assert inner.parent is None
