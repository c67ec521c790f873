"""The port's examples, run as a user runs them (subprocesses on the CPU):
the edge-deployment analyzer on a user-defined ADL file prints what the
reference's analyzer prints, ``serve_decode_torch.py --cgra --traffic
--smoke`` writes the committed ``BENCH_serve_decode.json`` row (and, for
zamba2 and deepseek-v3, the reference example's rows), the quickstart
runs, and the examples that simulate or serve refuse to run
without a card unless ``--device cpu`` is given."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from repro_torch.core import Toolchain, build_gemm, cluster_4x4

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
EXAMPLES = os.path.join(ROOT, "examples")
ADL = os.path.join(EXAMPLES, "cluster_4x4.adl.json")
COMMITTED = os.path.join(ROOT, "benchmarks", "results", "after",
                         "BENCH_serve_decode.json")


def _run(script, *args, cache, cuda=True, check=True):
    os.makedirs(cache, exist_ok=True)
    env = dict(os.environ, MORPHER_CACHE_DIR=str(cache),
               PYTHONPATH=os.path.join(ROOT, "src"))
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, script),
                          *args], env=env, capture_output=True, text=True,
                         timeout=600, cwd=str(cache))
    if check:
        assert res.returncode == 0, res.stdout + res.stderr
    return res


def _analysis(stdout):
    """The analyzer's report without its host timing line."""
    return [ln for ln in stdout.splitlines() if "analyzed in" not in ln]


def test_edge_deploy_on_a_user_adl_prints_the_reference_report(tmp_path):
    got = _run("edge_deploy_torch.py", "--arch-file", ADL,
               cache=tmp_path / "torch")
    want = _run("edge_deploy.py", "--arch-file", ADL,
                cache=tmp_path / "jax")
    assert "morpher-cluster-4x4, 4x4 PEs, 2 banks" in got.stdout
    assert "q_proj" in got.stdout and "16x8x16" in got.stdout
    assert _analysis(got.stdout) == _analysis(want.stdout)


def test_edge_deploy_loads_user_defined_adl(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "edge_deploy_torch", os.path.join(EXAMPLES, "edge_deploy_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    arch = mod.load_arch_file(ADL)
    assert arch.n_pes == 16 and len(arch.banks) == 2
    custom = cluster_4x4(regfile=16, name="user-cgra")
    path = tmp_path / "user.adl.json"
    path.write_text(custom.to_json())
    arch2 = mod.load_arch_file(str(path))
    assert arch2.name == "user-cgra" and arch2.regfile_size == 16
    Toolchain(arch2, cache_dir="").compile(
        build_gemm(TI=4, TK=4, TJ=4, arch=arch2)).verify(device="cpu")
    bad = tmp_path / "bad.adl.json"
    bad.write_text(custom.to_json().replace('"rows": 4', '"rows": 0'))
    with pytest.raises(ValueError):
        mod.load_arch_file(str(bad))


def test_serve_decode_cgra_smoke_writes_the_committed_row(tmp_path):
    out = tmp_path / "out"
    res = _run("serve_decode_torch.py", "--cgra", "--traffic", "--smoke",
               "--device", "cpu", "--out", str(out), cache=tmp_path)
    assert "spot-checked bit-exact" in res.stdout
    assert "serve_decode OK" in res.stdout
    with open(out / "BENCH_serve_decode.json", encoding="utf-8") as f:
        got = json.load(f)["rows"]
    with open(COMMITTED, encoding="utf-8") as f:
        want = json.load(f)["rows"]
    assert got == want[:1]
    plan = json.loads((out / "serve_plan.json").read_text())
    assert plan["model"] == "llama3.2-1b-serve-smoke"


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b", "deepseek-v3-671b"])
def test_serve_decode_cgra_smoke_rows_equal_the_reference(arch_id,
                                                          tmp_path):
    """The hybrid and the MLA + MoE families through both examples with
    the same flags: the same BENCH_serve_decode.json rows.  The port's
    example names and extends its row as the committed file's rows are
    (``serve_decode_<arch>``, plus the plan's sites and tiles); the
    reference example names it after the config (``...-serve-smoke``)."""
    flags = ("--cgra", "--traffic", "--smoke", "--arch", arch_id)
    rows = {}
    for script, extra in (("serve_decode_torch.py", ("--device", "cpu")),
                          ("serve_decode.py", ())):
        out = tmp_path / script
        res = _run(script, *flags, *extra, "--out", str(out),
                   cache=tmp_path / f"cache-{script}")
        assert "serve_decode OK" in res.stdout
        with open(out / "BENCH_serve_decode.json", encoding="utf-8") as f:
            rows[script] = json.load(f)["rows"]
    (got,), (want,) = rows["serve_decode_torch.py"], rows["serve_decode.py"]
    assert want["name"] == f"serve_decode_{arch_id}-serve-smoke"
    assert got["name"] == f"serve_decode_{arch_id}"
    assert got["us"] == want["us"]
    for extra in ("sites", "tiles"):
        assert got["derived"].pop(extra) > 0
    assert got["derived"] == want["derived"]


def test_quickstart_runs_on_the_cpu(tmp_path):
    res = _run("quickstart_torch.py", "--device", "cpu", cache=tmp_path)
    assert "quickstart OK" in res.stdout


@pytest.mark.parametrize("script,args", [
    ("serve_decode_torch.py", ("--smoke",)),
    ("quickstart_torch.py", ())])
def test_examples_need_a_device_without_a_card(script, args, tmp_path):
    res = _run(script, *args, cache=tmp_path, cuda=False, check=False)
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
