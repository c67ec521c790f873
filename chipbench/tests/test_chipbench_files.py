"""The benchmark's files: every one parses, names and units use the
allowed characters, every cell and metric finds its files, and a file
dropped into a copy is found without an edit."""
import hashlib
import json
import os
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
# what a cut may change: the depth, and what one chip of a stated
# deployment holds of a layer (its experts, heads, rows of the vocabulary);
# never a width, a window, the experts per token or the dtype
CUT = re.compile(r"^(num_hidden_layers|num_layers|n_layers?|num_local_experts|"
                 r"num_experts|n_routed_experts|n_experts|num_attention_heads|"
                 r"num_key_value_heads|n_heads|n_kv_heads|mamba_n_heads|"
                 r"vocab_size|vocab)$")


def reduced_faults(data, entry):
    """What is wrong with a configuration file's cut (empty for nothing).
    ``published_as`` maps each key of ``published`` to the ``model`` key
    that runs it, or to null where no one key of the port's does; the
    value as run, there and at the file's top level (a catalog
    configuration's own key), is the published one unless the key is in
    ``reduced``.  A key in ``reduced`` counts depth or a chip's share
    (``CUT``) and is run below its published value; a cut file says in
    ``deployment`` how many chips share each layer, and how; the entry in
    BENCHMARK.json lists the same keys."""
    reduced, published = data["reduced"], data["published"]
    runs_as = data.get("published_as", {})
    faults = []
    if reduced != entry["reduced"]:
        faults.append("BENCHMARK.json's reduced differs from the file's")
    if len(reduced) > 16 or not all(NAME.match(k) for k in reduced):
        faults.append("reduced has more than 16 keys or a malformed one")
    if reduced and not (isinstance(data.get("deployment"), str)
                        and data["deployment"].strip()):
        faults.append("a cut configuration states no deployment")
    for key in reduced:
        if not CUT.match(key):
            faults.append(f"{key} is neither depth nor a chip's share")
        if key not in published:
            faults.append(f"{key} has no published value")
    for key in sorted(set(runs_as) - set(published)):
        faults.append(f"{key} is mapped but not published")
    for key, value in published.items():
        if key not in runs_as:
            faults.append(f"{key} is published but not mapped to the model")
            continue
        as_run = [data[key]] if key in data else []
        if runs_as[key] is not None:
            if runs_as[key] not in data["model"]:
                faults.append(f"{key} maps to {runs_as[key]}, which the "
                              f"model does not have")
                continue
            as_run.append(data["model"][runs_as[key]])
        if key not in reduced:
            if any(v != value for v in as_run):
                faults.append(f"{key} is cut but not in reduced")
        elif not as_run:
            faults.append(f"{key} has no value as run")
        elif not all(isinstance(v, (int, float)) and v < value
                     for v in as_run):
            faults.append(f"{key} is not run below its published value")
    return faults


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
    assert reduced_faults(data, cfg) == []
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


_CUT = {"published": {"num_hidden_layers": 40, "num_local_experts": 72,
                      "num_experts_per_tok": 10, "hidden_size": 4096,
                      "sliding_window": 4096, "torch_dtype": "bfloat16"},
        "published_as": {"num_hidden_layers": "n_layers",
                         "num_local_experts": "n_experts",
                         "num_experts_per_tok": "top_k",
                         "hidden_size": "d_model", "sliding_window": None,
                         "torch_dtype": "dtype"},
        "model": {"n_layers": 10, "n_experts": 9, "top_k": 10,
                  "d_model": 4096, "dtype": "bfloat16"},
        "num_hidden_layers": 10, "num_local_experts": 9,
        "num_experts_per_tok": 10, "hidden_size": 4096,
        "sliding_window": 4096, "torch_dtype": "bfloat16",
        "reduced": ["num_hidden_layers", "num_local_experts"],
        "deployment": "8 chips share each layer, 9 of its 72 experts each, "
                      "and 4 hold the 40 layers as pipeline stages"}
_CATALOG = ("num_hidden_layers", "num_local_experts", "num_experts_per_tok",
            "hidden_size", "sliding_window", "torch_dtype")


def _cut(top=True, model=None, **change):
    """``_CUT`` changed: ``top`` False drops the catalog's own keys at the
    top level, ``model`` updates the values as run, a None drops a key."""
    data = json.loads(json.dumps(_CUT))
    if not top:
        for key in _CATALOG:
            data.pop(key)
    data["model"].update(model or {})
    for key, value in change.items():
        if value is None:
            data.pop(key)
        else:
            data[key] = value
    return data


def _also(key, top_value, model_key, model_value):
    """``_CUT`` with ``key`` cut too, at the top level and in the model."""
    return _cut(reduced=_CUT["reduced"] + [key], model={model_key:
                                                       model_value},
                **{key: top_value})


@pytest.mark.parametrize("data, entry_reduced, fault", [
    (_cut(), None, None),
    (_cut(top=False), None, None),
    (_cut(deployment=None), None, "states no deployment"),
    (_cut(deployment=" "), None, "states no deployment"),
    (_also("hidden_size", 2048, "d_model", 2048), None,
     "hidden_size is neither depth nor a chip's share"),
    (_also("num_experts_per_tok", 2, "top_k", 2), None,
     "num_experts_per_tok is neither"),
    (_also("torch_dtype", "float16", "dtype", "float16"), None,
     "torch_dtype is neither"),
    (_cut(reduced=_CUT["reduced"] + ["sliding_window"], sliding_window=1024),
     None, "sliding_window is neither"),
    (_cut(reduced=[], deployment=None), None,
     "num_hidden_layers is cut but not in reduced"),
    (_cut(top=False, reduced=["num_local_experts"], model={"n_layers": 19}),
     None, "num_hidden_layers is cut but not in reduced"),
    (_cut(num_local_experts=72, model={"n_experts": 72}), None,
     "num_local_experts is not run below"),
    (_cut(model={"n_experts": 80}), None, "num_local_experts is not run "
                                          "below"),
    (_cut(reduced=_CUT["reduced"] + ["vocab_size"]), None,
     "vocab_size has no published value"),
    (_cut(published_as=dict(_CUT["published_as"], hidden_size="d_hidden")),
     None, "hidden_size maps to d_hidden"),
    (_cut(published_as={k: v for k, v in _CUT["published_as"].items()
                        if k != "sliding_window"}), None,
     "sliding_window is published but not mapped"),
    (_cut(), ["num_hidden_layers"], "BENCHMARK.json's reduced differs"),
], ids=["cut", "cut_in_model", "no_deployment", "blank_deployment",
        "a_width", "experts_per_token", "dtype", "sliding_window",
        "unlisted_cut", "unlisted_cut_in_model", "as_published", "grown",
        "unpublished", "mapped_to_nothing", "unmapped", "entry_differs"])
def test_the_reduced_rule(data, entry_reduced, fault):
    """A configuration cut to one chip's share passes; each departure
    from the rule is named."""
    entry = {"reduced": data["reduced"] if entry_reduced is None
             else entry_reduced}
    faults = reduced_faults(data, entry)
    if fault is None:
        assert faults == []
    else:
        assert any(fault in f for f in faults), faults


def _digests(root: Path):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


DROPPED = ("test_every_config_file_parses_and_records_its_source[dropin-half]",
           "test_every_cell_finds_its_files[dropin-half.chat]",
           "test_reference_logits_match_the_port[dropin-half]",
           "test_reference_follows_prefill_then_decode[dropin-half]",
           "test_a_sound_cpu_run_is_correct[dropin-half.chat]",
           "test_a_token_altered_where_produced_is_caught[dropin-half.chat]",
           "test_a_decode_step_that_leaves_its_state_unchanged_is_caught"
           "[dropin-half.chat]",
           "test_the_control_reads_far_above_the_program[dropin-half.chat]",
           "test_every_metric_has_a_reader_and_allowed_names[dropin_probe]")


def test_a_dropped_in_family_runs_correct_without_an_edit(tmp_path):
    """A copy of the harness gains a family (its reference module, here
    zamba2's under another name), a configuration of it cut to half its
    depth, a serving cell and a metric, by new files and new entries
    alone.  The copy's own tests, unedited, pass on the new names: the
    files parse, the reference follows the port, a tiny CPU run of the
    cell is judged correct, a token altered where it is produced and a
    step that leaves its state unchanged are caught, and the control
    fails the cell's limit.  No file under the copy's ``chipbench/`` is
    changed; BENCHMARK.json gains entries."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "chipbench")
    (root / "chipbench/reference/dropin.py").write_text(
        (harness.HERE / "reference/zamba2.py").read_text())
    cfg = harness.config("zamba2-1.2b")
    cfg.update(name="dropin-half", family="dropin", num_hidden_layers=19,
               reduced=["num_hidden_layers"],
               deployment="two chips hold the model as two pipeline stages "
                          "of 19 layers; this chip holds the first")
    cfg["model"]["n_layers"] = 19
    cfg["derived"]["attention_applications"] = 3
    (root / "chipbench/configs/dropin-half.json").write_text(json.dumps(cfg))
    cell = harness.workload("zamba2-1.2b.chat")
    cell.update(name="dropin-half.chat", config="dropin-half")
    (root / "chipbench/workloads/dropin-half.chat.json").write_text(
        json.dumps(cell))
    (root / "chipbench/metrics/dropin_probe.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dropin-half", "source": "a copy",
                             "file": "chipbench/configs/dropin-half.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a dropped-in family"})
    bench["workloads"].append({"name": "dropin-half.chat",
                               "config": "dropin-half", "traffic": "chat",
                               "chips": 1, "why": "a dropped-in cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("dropin-half.chat")
    bench["per_layer"].append({"name": "dropin_probe", "unit": "count",
                               "better": "lower", "source": "host_clock",
                               "layer": "clients",
                               "moves": "output_tokens_per_s",
                               "workloads": ["dropin-half.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-k", "dropin", "chipbench/tests"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(harness.SRC),
                 OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
    passed = {line.split("::", 1)[-1] for line in proc.stdout.splitlines()
              if line.startswith("PASSED ")}
    assert set(DROPPED) <= passed, sorted(passed)
    after = _digests(root / "chipbench")
    assert {k: after.get(k) for k in before} == before
