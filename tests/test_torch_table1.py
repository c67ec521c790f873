"""The port's Table I (``benchmarks/table1_torch.py``) and bench harness
(``benchmarks/run_torch.py``) against the reference's on the CPU.

Table I: every field (nodes, II, MII, utilization, compute / transfer /
total ms, speedup) equal to the reference's ``table1.run()``, with the
port's small-dims variants verified by simulation on the CPU.  The
harness: ``mapper_sweep``'s derived fields equal the committed
``benchmarks/results/after/BENCH_mapper_sweep.json``, ``frontend_trace``'s
row names and node counts equal the committed ones, ``toolchain_cache``'s
warm pass is all ``from_cache``, ``--check-regression`` gives
``run.py``'s verdicts, and ``--only`` refuses an unknown name."""
import importlib
import json
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
COMMITTED = os.path.join(ROOT, "benchmarks", "results", "after")


def _bench(name):
    return importlib.import_module(f"benchmarks.{name}")


def test_table1_matches_reference(monkeypatch):
    monkeypatch.setenv("MORPHER_CACHE_DIR", "")   # both map cold
    port = _bench("table1_torch").run(device="cpu")
    ref = _bench("table1").run(verify=False)
    assert list(port) == list(ref) == ["GEMM", "GEMM-U", "GEMM-U-C", "CONV",
                                       "CONV-U-C-1", "CONV-U-C-2"]
    for name, want in ref.items():
        got = port[name]
        assert (got is None) == (want is None), name
        for field in ("nodes", "II", "mii", "utilization", "compute_ms",
                      "transfer_ms", "total_ms", "speedup"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    assert [r["name"] for r in _bench("table1_torch").rows_of(port)] == \
        list(ref)


def test_table1_constants_are_the_reference_s():
    port, ref = _bench("table1_torch"), _bench("table1")
    for const in ("PAPER", "TRAFFIC", "PROBLEM_SCALE", "HANDSHAKE_US"):
        assert getattr(port, const) == getattr(ref, const), const


def test_mapper_sweep_bench_file_matches_committed(tmp_path):
    """``--only mapper_sweep_torch`` writes a schema-1 BENCH file whose rows
    carry the reference's names and the committed derived fields."""
    _bench("run_torch").main(["--only", "mapper_sweep_torch", "--out",
                              str(tmp_path)])
    with open(tmp_path / "BENCH_mapper_sweep_torch.json") as f:
        got = json.load(f)
    with open(os.path.join(COMMITTED, "BENCH_mapper_sweep.json")) as f:
        want = json.load(f)
    assert got["bench"] == "mapper_sweep_torch" and got["schema"] == 1
    assert "git_sha" in got
    assert [r["name"] for r in got["rows"]] == \
        [r["name"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert g["derived"] == w["derived"], g["name"]


def test_frontend_trace_bench_file_matches_committed(tmp_path):
    """``--only frontend_trace_torch`` on the CPU writes a schema-1 BENCH
    file whose rows carry the reference's names and node counts (the
    committed ``BENCH_frontend_trace.json``), each warm compile served from
    the cache (asserted inside the bench) and timed."""
    _bench("run_torch").main(["--only", "frontend_trace_torch", "--device",
                              "cpu", "--out", str(tmp_path)])
    with open(tmp_path / "BENCH_frontend_trace_torch.json") as f:
        got = json.load(f)
    with open(os.path.join(COMMITTED, "BENCH_frontend_trace.json")) as f:
        want = json.load(f)
    assert got["bench"] == "frontend_trace_torch" and got["schema"] == 1
    assert [r["name"] for r in got["rows"]] == \
        [r["name"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert g["derived"]["nodes"] == w["derived"]["nodes"], g["name"]
        assert g["us"] > 0 and g["derived"]["warm_compile_us"] > 0
        ratio = g["us"] / g["derived"]["warm_compile_us"]
        assert abs(g["derived"]["ratio"] - ratio) < 1e-3, g["name"]


def test_toolchain_cache_warm_pass_is_all_from_cache():
    rows = _bench("run_torch").bench_toolchain_cache()
    (row,) = rows
    assert row["name"] == "toolchain_cache"
    assert row["derived"]["kernels"] == 6 and row["us"] > 0


def _write(path, bench, rows):
    with open(path, "w") as f:
        json.dump({"bench": bench, "schema": 1, "git_sha": None,
                   "rows": rows}, f)


@pytest.mark.parametrize("after_us,missing", [(110.0, False), (130.0, False),
                                              (100.0, True)])
def test_check_regression_agrees_with_reference(tmp_path, capsys, after_us,
                                                missing):
    """Two crafted directories: a row within, then beyond, the tolerance;
    an informational row (no duration); rows only on one side.  The exit
    status and every printed verdict equal ``run.py``'s."""
    before, after = tmp_path / "before", tmp_path / "after"
    before.mkdir()
    after.mkdir()
    _write(before / "BENCH_x.json", "x", [
        {"name": "a", "us": 100.0, "derived": {}},
        {"name": "info", "us": None, "derived": {"unmapped": 1}},
        {"name": "gone", "us": 5.0, "derived": {}}])
    rows = [{"name": "a", "us": after_us, "derived": {}},
            {"name": "info", "us": None, "derived": {"unmapped": 1}}]
    if not missing:
        rows.append({"name": "new", "us": 7.0, "derived": {}})
    _write(after / "BENCH_x.json", "x", rows)
    out = []
    for mod in ("run_torch", "run"):
        rc = _bench(mod).check_regression(str(before), str(after), tol=0.15)
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[0][0] == (1 if after_us > 115 else 0)
    with pytest.raises(SystemExit) as exc:
        _bench("run_torch").main(["--check-regression", str(before),
                                  str(after)])
    assert exc.value.code == out[0][0]


def test_only_rejects_an_unknown_name(capsys):
    with pytest.raises(SystemExit) as exc:
        _bench("run_torch").main(["--only", "table1"])
    assert exc.value.code == 2
    assert "unknown benchmark" in capsys.readouterr().err


def test_every_bench_is_named_with_torch():
    """Twelve benches: the reference's four host benches and the eight of
    ``repro_torch.bench``, each name ending in ``_torch``."""
    benches = _bench("run_torch").BENCHES
    assert len(benches) == 12 and all(n.endswith("_torch") for n in benches)
    assert {n[:-len("_torch")] for n in benches} <= \
        set(_bench("run").BENCHES) | {"kernel_micro"}
