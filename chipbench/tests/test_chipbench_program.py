"""The readers of the program's own spans (``chipbench/program.py``)
against hand counts on a small, made-up run: one prefill and two decode
steps of a two-layer model, their program spans, and a stretch of
100 ms in which the card is busy three times."""
import pytest

from chipbench import harness, program
from chipbench.drivers.serve import Served
from chipbench.trace import DeviceOp, Span, Stretch, idle_by_host_span
from repro_torch.spans import Span as PSpan

MS = 1_000_000      # ns


class FakeRun(harness.Run):
    def device_kind(self):
        return "NVIDIA H100 80GB HBM3"


def _program():
    """The program's spans as ``repro_torch.spans.take()`` gives them:
    an admission, then two decode steps (ms for ns)."""
    rows = [("engine.admit", 1, 29, None, {"rid": 0, "tokens": 2000}),
            ("model.prefill", 2, 20, 0, {"tokens": 2000}),
            ("block.rwkv6", 3, 10, 1, {"layer": 0}),
            ("block.rwkv6", 10, 18, 1, {"layer": 1}),
            ("model.head", 18, 19, 1, {}),
            ("engine.admit.merge", 20, 22, 0, {}),
            ("engine.admit.readback", 22, 28, 0, {}),
            ("engine.step", 31, 59, None, {"active": 64, "batch": 64}),
            ("engine.step.inputs", 31, 33, 7, {}),
            ("model.decode", 33, 50, 7, {}),
            ("block.rwkv6", 34, 40, 9, {"layer": 0}),
            ("block.rwkv6", 40, 48, 9, {"layer": 1}),
            ("model.head", 48, 49, 9, {}),
            ("engine.step.readback", 50, 57, 7, {}),
            ("engine.step.finish", 57, 59, 7, {}),
            ("engine.step", 61, 94, None, {"active": 64, "batch": 64}),
            ("engine.step.inputs", 61, 62, 15, {}),
            ("model.decode", 62, 80, 15, {}),
            ("block.rwkv6", 62, 70, 17, {"layer": 0}),
            ("block.rwkv6", 70, 79, 17, {"layer": 1}),
            ("model.head", 79, 80, 17, {}),
            ("engine.step.readback", 80, 92, 15, {}),
            ("engine.step.finish", 92, 94, 15, {})]
    return [PSpan(n, t0 * MS, t1 * MS, p, m) for n, t0, t1, p, m in rows]


def _run(cfg_name="rwkv6-1.6b-fp32", with_program=True):
    meta = {"batch": 64, "active": 64, "ctx_all": 6400, "ctx_active": 6400}
    pre = Span("prefill", 0, 30 * MS, {"tokens": 2000})
    s1 = Span("decode_step", 30 * MS, 60 * MS, dict(meta))
    s2 = Span("decode_step", 60 * MS, 95 * MS, dict(meta))
    ops = [DeviceOp("wkv6_local_kernel", 5 * MS, 25 * MS, True, 3 * MS, pre),
           DeviceOp("wkv6_decode_kernel", 36 * MS, 55 * MS, True, 34 * MS,
                    s1),
           DeviceOp("decode_split_tc_kernel", 66 * MS, 90 * MS, True,
                    63 * MS, s2)]
    run = FakeRun(cell={}, cfg=harness.config(cfg_name), seed=0, seconds=0,
                  trace=True)
    run.spans = [pre, s1, s2]
    run.window = (0, 100 * MS)
    run.stretch = Stretch(0, 100 * MS, ops, len(ops))
    reqs = []
    for i, times in enumerate(([30, 60, 95], [30, 95])):
        s = Served(i, None, 0)
        s.times = [t * MS for t in times]
        s.t_first = s.times[0]
        reqs.append(s)
    run.requests = reqs
    if with_program:
        run.program_spans = _program()
        run.window_program_spans = run.program_spans
    return run


# Idle: 0-5, 25-36, 55-66, 90-100 ms; by hand, in ms:
GAPS = {"prefill": 2, "prefill/engine.admit": 2, "prefill/model.prefill": 1,
        "prefill/block.rwkv6": 2, "prefill/engine.admit.readback": 3,
        "decode_step": 4, "decode_step/engine.step.inputs": 3,
        "decode_step/model.decode": 1, "decode_step/block.rwkv6": 6,
        "decode_step/engine.step.readback": 4,
        "decode_step/engine.step.finish": 4, "outside spans": 5}


def test_the_made_up_program_spans_nest():
    spans = _program()
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_idle_time_goes_to_the_innermost_program_span():
    got = dict(program.idle_gaps_program(_run(), n=None))
    assert got.keys() == GAPS.keys()
    for k, ms in GAPS.items():
        assert got[k] == pytest.approx(ms / 1e3), k


def test_idle_gaps_program_keeps_the_ten_largest():
    got = program.idle_gaps_program(_run())
    assert len(got) == 10
    assert [v for _, v in got] == sorted((v for _, v in got), reverse=True)
    assert got[0] == ["decode_step/block.rwkv6", pytest.approx(6e-3)]


@pytest.mark.parametrize("bench", ["decode_step", "prefill",
                                   "outside spans"])
def test_program_gaps_add_up_to_the_benchmarks(bench):
    run = _run()
    whole = dict(idle_by_host_span(run.stretch, run.spans))
    parts = [v for k, v in program.idle_gaps_program(run, n=None)
             if k == bench or k.startswith(bench + "/")]
    assert sum(parts) == pytest.approx(whole[bench])


def test_decode_launch_ms_by_hand():
    """model.decode 33-50 and 62-80 ms over two steps."""
    assert program.decode_launch_ms(_run()) == pytest.approx(17.5)


def test_decode_readback_ms_by_hand():
    """engine.step.readback 50-57 and 80-92 ms over two steps."""
    assert program.decode_readback_ms(_run()) == pytest.approx(9.5)


def test_the_host_times_fit_in_a_step():
    """Launch and readback lie inside their steps: together no longer
    than the mean step."""
    run = _run()
    steps = [s for s in run.spans if s.name == "decode_step"]
    mean_step = sum(s.t1 - s.t0 for s in steps) / 1e6 / len(steps)
    assert program.decode_launch_ms(run) + \
        program.decode_readback_ms(run) <= mean_step


def test_prefill_launch_idle_ms_per_ktok_by_hand():
    """Idle 2-5 ms inside model.prefill, 2000 prompt tokens."""
    assert program.prefill_launch_idle_ms_per_ktok(_run()) == \
        pytest.approx(1.5)


def test_steps_past_the_stretch_are_left_out():
    run = _run()
    late = Span("decode_step", 96 * MS, 120 * MS, {"batch": 64})
    run.spans.append(late)
    run.program_spans.append(PSpan("model.decode", 97 * MS, 119 * MS))
    assert program.decode_launch_ms(run) == pytest.approx(17.5)


def _window_after(run):
    """``run`` with a window of its own after the traced stretch, 200-300
    ms, whose program spans ran without the profiler: two decode steps
    whose launch takes 0.1 ms and whose readback 20."""
    meta = {"batch": 64, "active": 64, "ctx_all": 6400, "ctx_active": 6400}
    rows = []
    for t in (200, 250):
        run.spans.append(Span("decode_step", t * MS, (t + 25) * MS,
                              dict(meta)))
        i = len(rows)
        rows += [PSpan("engine.step", t * MS, (t + 24) * MS),
                 PSpan("model.decode", t * MS + MS, t * MS + MS + MS // 10,
                       i),
                 PSpan("engine.step.readback", (t + 2) * MS, (t + 22) * MS,
                       i)]
    run.window = (200 * MS, 300 * MS)
    run.window_program_spans = rows
    return run


@pytest.mark.parametrize("reader, hand", [("decode_launch_ms", 0.1),
                                          ("decode_readback_ms", 20.0)])
def test_host_times_come_from_the_window(reader, hand):
    """The host's times a step are read over the window's steps and
    program spans alone; the profiled stretch's, whose launches the
    profiler slows, are left out."""
    assert getattr(program, reader)(_window_after(_run())) == \
        pytest.approx(hand)


def test_idle_time_comes_from_the_profiled_stretch():
    """The card's idle time is read in the profiled stretch as before; the
    window, which has no trace, adds nothing."""
    run = _window_after(_run())
    assert program.prefill_launch_idle_ms_per_ktok(run) == \
        pytest.approx(1.5)
    assert dict(program.idle_gaps_program(run, n=None)) == \
        pytest.approx({k: v / 1e3 for k, v in GAPS.items()})


READERS = ("decode_launch_ms", "decode_readback_ms",
           "prefill_launch_idle_ms_per_ktok")


@pytest.mark.parametrize("name", READERS)
def test_a_run_without_program_spans_reads_nothing(name):
    """As a program without spans gives: no field, or an empty list."""
    bare = _run(with_program=False)
    assert not hasattr(bare, "program_spans")
    assert getattr(program, name)(bare) is None
    bare.program_spans = []
    assert getattr(program, name)(bare) is None
    assert program.idle_gaps_program(bare) is None


SERVING = [c["name"] for c in harness.benchmark()["workloads"]
           if harness.workload(c["name"])["driver"] == "serve"]


@pytest.mark.parametrize("cell", SERVING)
def test_every_accepted_metric_reads_the_same_with_program_spans(cell):
    """The metrics that read the benchmark's spans and the trace read the
    same whether the run holds the program's spans or not; those that
    re-export a reader of ``chipbench.program`` read a number with them
    and nothing without."""
    bench = harness.benchmark()
    cfg_name = harness.workload(cell)["config"]
    full, bare = _run(cfg_name), _run(cfg_name, with_program=False)
    for trace in (False, True):
        for m in harness.metrics_of(bench, cell, trace):
            mod = harness.metric_module(m["name"])
            if mod.read.__module__ == program.__name__:
                assert mod.read(bare) is None, m["name"]
                assert mod.read(full) is not None, m["name"]
            else:
                assert mod.read(full) == mod.read(bare), m["name"]
    assert idle_by_host_span(full.stretch, full.spans) == \
        idle_by_host_span(bare.stretch, bare.spans)


@pytest.mark.parametrize("name, reader, hand", [
    ("decode_launch_ms", "decode_launch_ms", 17.5),
    ("decode_readback_ms", "decode_readback_ms", 9.5),
    ("prefill_launch_idle_ms_per_ktok.rag",
     "prefill_launch_idle_ms_per_ktok", 1.5),
    ("prefill_launch_idle_ms_per_ktok.chat",
     "prefill_launch_idle_ms_per_ktok", 1.5)])
def test_the_program_metrics_are_its_readers(name, reader, hand):
    """Each metric file of the program's spans is a reader of
    ``chipbench.program``, read by hand on the made-up run, and listed
    for every serving cell of its end-to-end metric."""
    mod = harness.metric_module(name)
    assert mod.read is getattr(program, reader)
    assert mod.read(_run()) == pytest.approx(hand)
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == name)
    assert entry["source"] == "program_span"
    assert set(entry["workloads"]) <= set(SERVING)
