"""The benchmark's files: every one parses, names and units use the
allowed characters, every cell and metric finds its files, and a file
dropped into a copy is found without an edit."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}


def test_benchmark_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for p in BENCH["paths"]:
        assert (harness.ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    wl = harness.workload(cell["name"])
    assert wl["name"] == cell["name"] and wl["config"] == cell["config"]
    assert wl["chips"] == cell["chips"]
    cfg = harness.config(cell["config"])
    assert cfg["name"] == cell["config"]
    harness.driver(wl)
    harness.reference(cfg)
    e2e = harness.metrics_of(BENCH, cell["name"], False)
    layer = harness.metrics_of(BENCH, cell["name"], True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    moved = {m["name"] for m in e2e}
    assert all(m["moves"] in moved for m in layer)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_parses_and_records_its_source(cfg):
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"chipbench/configs/{cfg['name']}.json"
    data = harness.load_json(harness.ROOT / cfg["file"])
    for key in ("source", "published", "model", "reduced", "assumed",
                "departures", "flops"):
        assert key in data, key
    assert data["reduced"] == cfg["reduced"] == []
    assert len(data["source"]) <= 200 and data["departures"]
    mcfg = harness.model_config(data)
    for key, value in data["model"].items():
        got = getattr(mcfg, key)
        assert str(got).endswith(str(value)), key
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_and_allowed_names(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= E2E_KEYS
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= LAYER_KEYS
        assert "\n" not in metric["layer"] and metric["layer"]
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert callable(harness.metric_module(metric["name"]).read)
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_dropped_in_cell_is_found_without_an_edit(tmp_path):
    """A copy of the harness gains a cell, a configuration and a metric by
    new files and new entries alone; the copy's run finds all three."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.config("zamba2-1.2b")
    cfg["name"] = "zamba2-1.2b-copy"
    (root / "chipbench/configs/zamba2-1.2b-copy.json").write_text(
        json.dumps(cfg))
    cell = harness.workload("zamba2-1.2b.chat")
    cell.update(name="zamba2-1.2b-copy.burst", config="zamba2-1.2b-copy")
    (root / "chipbench/workloads/zamba2-1.2b-copy.burst.json").write_text(
        json.dumps(cell))
    (root / "chipbench/metrics/new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append(dict(bench["configs"][-1],
                                 name="zamba2-1.2b-copy",
                                 file="chipbench/configs/"
                                      "zamba2-1.2b-copy.json"))
    bench["workloads"].append({"name": "zamba2-1.2b-copy.burst",
                               "config": "zamba2-1.2b-copy",
                               "traffic": "burst", "chips": 1,
                               "why": "a copy"})
    bench["per_layer"].append({"name": "new_metric", "unit": "count",
                               "better": "lower", "source": "host_clock",
                               "layer": "clients",
                               "moves": "output_tokens_per_s",
                               "workloads": ["zamba2-1.2b-copy.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from chipbench import harness\n"
        "b = harness.benchmark()\n"
        "c = harness.workload('zamba2-1.2b-copy.burst')\n"
        "cfg = harness.config(c['config'])\n"
        "ms = harness.metrics_of(b, c['name'], True)\n"
        "print(cfg['name'], harness.HERE, [m['name'] for m in ms],\n"
        "      harness.metric_module('new_metric').read(None))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root),
                          str(harness.SRC)], capture_output=True, text=True,
                         check=True).stdout
    assert "zamba2-1.2b-copy" in out and str(root / "chipbench") in out
    assert "'new_metric'" in out and "42.0" in out


def test_run_exits_without_a_result_where_the_program_is_missing(tmp_path):
    """In a directory holding only BENCHMARK.json and the harness, a run
    exits with another code than 0 and prints no result line."""
    shutil.copytree(harness.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    cell = BENCH["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
