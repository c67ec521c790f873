"""Port's CGRA-backed serving layer against the JAX reference on the CPU:
the zoo's GEMM-site analyzer (``core.offload``), serve plans (``to_json``
byte-equal, reference-written plans loading in the port, ref-only plans
resolved through ``Toolchain.load_artifact``), the spot check,
``CGRAExecutionModel``, a traffic episode under a plan, the
``serve_decode`` bench rows, and the ten configs field by field.

Each package compiles through its own Toolchain on its own temporary
cache; the port simulates on ``device="cpu"``.  Everything here is exact:
plans, reports and rows are compared byte for byte."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.core.adl import cluster_4x4 as jax_cluster_4x4
from repro.core.offload import GemmSite as JaxGemmSite
from repro.core.offload import analyze_arch_gemms as jax_analyze
from repro.core.offload import choose_gemm_tile as jax_choose_tile
from repro.core.offload import model_gemm_sites as jax_sites
from repro.core.toolchain import Toolchain as JaxToolchain
from repro.models.zoo import build_model as jax_build
from repro.serve.engine import Engine as JaxEngine
from repro.serve.plan import CGRAExecutionModel as JaxExecModel
from repro.serve.plan import build_serve_plan as jax_build_plan
from repro.serve.traffic import TrafficConfig as JaxTraffic
from repro.serve.traffic import report_json as jax_report_json
from repro.serve.traffic import run_traffic as jax_run_traffic
from repro_torch.bench import bench_serve_decode
from repro_torch.configs.registry import get_config, serve_smoke_config
from repro_torch.core.adl import cluster_4x4
from repro_torch.core.offload import (GemmSite, analyze_arch_gemms,
                                      choose_gemm_tile, model_gemm_sites)
from repro_torch.core.toolchain import Toolchain
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import Engine
from repro_torch.serve.plan import (CGRAExecutionModel, ServePlan,
                                    build_serve_plan)
from repro_torch.serve.traffic import TrafficConfig, report_json, run_traffic

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
COMMITTED = os.path.join(ROOT, "benchmarks", "results", "after",
                         "BENCH_serve_decode.json")
SMOKE = ("llama3.2-1b", "rwkv6-1.6b")
# one config per family of model_gemm_sites: dense, ssm, hybrid, moe, MLA
FAMILIES = ("llama3.2-3b", "rwkv6-1.6b", "zamba2-1.2b",
            "llama4-maverick-400b-a17b", "deepseek-v3-671b")
SPOT_SEEDS = (0, 1)


@pytest.fixture(scope="module")
def toolchains(tmp_path_factory):
    """(reference, port) Toolchains, each on its own temporary cache."""
    return (JaxToolchain(cache_dir=str(tmp_path_factory.mktemp("jax"))),
            Toolchain(cache_dir=str(tmp_path_factory.mktemp("torch"))))


def _configs(arch_id, smoke):
    if smoke:
        return jax_smoke(arch_id), serve_smoke_config(arch_id)
    return jax_get_config(arch_id), get_config(arch_id)


@pytest.fixture(scope="module")
def plans(toolchains):
    """(reference plan, port plan) of llama3.2-1b's smoke config."""
    jtc, ttc = toolchains
    jcfg, tcfg = _configs("llama3.2-1b", smoke=True)
    return (jax_build_plan(jcfg, toolchain=jtc, spot_check=False),
            build_serve_plan(tcfg, toolchain=ttc, spot_check=False))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_config_equals_the_reference(arch_id):
    jcfg, tcfg = jax_get_config(arch_id), get_config(arch_id)
    want = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(jcfg) if f.name != "scan_unroll"}
    got = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert (want.pop("dtype"), got.pop("dtype")) == (jnp.bfloat16,
                                                     torch.bfloat16)
    assert got == want
    assert tcfg.params_dense == jcfg.params_dense
    assert tcfg.params_active == jcfg.params_active


# ------------------------------------------------------- sites and tiles
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_gemm_sites_and_tiles_equal_the_reference(arch_id):
    jcfg, tcfg = jax_get_config(arch_id), get_config(arch_id)
    for tokens in (64, 1):
        want = jax_sites(jcfg, tokens)
        got = model_gemm_sites(tcfg, tokens)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
        assert [s.n_layers(tcfg) for s in got] == \
            [s.n_layers(jcfg) for s in want]
        assert [choose_gemm_tile(cluster_4x4(), s) for s in got] == \
            [jax_choose_tile(jax_cluster_4x4(), s) for s in want]
    clamping = dict(name="clamp", M=3, K=2, N=5)
    assert choose_gemm_tile(cluster_4x4(), GemmSite(**clamping)) == \
        jax_choose_tile(jax_cluster_4x4(), JaxGemmSite(**clamping)) == \
        (3, 2, 5)


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_analyze_arch_gemms_equals_the_reference(arch_id, toolchains):
    jtc, ttc = toolchains
    want = jax_analyze(arch_id, max_kernels=3, toolchain=jtc)
    got = analyze_arch_gemms(arch_id, max_kernels=3, toolchain=ttc)
    assert len(got) == 3
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


# -------------------------------------------------------------------- plans
@pytest.mark.parametrize("arch_id,smoke",
                         [(a, False) for a in ARCH_IDS]
                         + [(a, True) for a in SMOKE],
                         ids=lambda v: str(v))
def test_plan_json_byte_equal_to_the_reference(arch_id, smoke, toolchains):
    jtc, ttc = toolchains
    jcfg, tcfg = _configs(arch_id, smoke)
    want = jax_build_plan(jcfg, toolchain=jtc, spot_check=False)
    got = build_serve_plan(tcfg, toolchain=ttc, spot_check=False)
    assert got.to_json() == want.to_json()
    assert got.to_json(embed_kernels=False) == \
        want.to_json(embed_kernels=False)
    assert got.summary() == want.summary()


def test_reference_plan_loads_in_the_port(plans, toolchains, tmp_path):
    jplan, tplan = plans
    jtc, ttc = toolchains
    loaded = ServePlan.from_json(jplan.to_json())
    assert loaded.to_json() == jplan.to_json()
    assert loaded.decode_step_s(4) == jplan.decode_step_s(4)

    ref_only = jplan.to_json(embed_kernels=False)
    assert len(ref_only) < len(jplan.to_json())
    assert ServePlan.from_json(ref_only).kernels == {}
    # through the memo of the toolchain that compiled the port's plan, and
    # from the reference's on-disk cache through a fresh port toolchain
    for tc in (ttc, Toolchain(cache_dir=jtc.cache_dir)):
        resolved = ServePlan.from_json(ref_only, toolchain=tc)
        assert resolved.to_json() == jplan.to_json()
    # a cache that lacks the tiles leaves the kernels unresolved
    empty = Toolchain(cache_dir=str(tmp_path))
    unresolved = ServePlan.from_json(ref_only, toolchain=empty)
    with pytest.raises(KeyError, match="not bundled"):
        unresolved.kernel_for(unresolved.sites[0])


def test_load_artifact_memo_disk_and_unknown(plans, toolchains, tmp_path):
    _, tplan = plans
    _, ttc = toolchains
    key = tplan.sites[0].kernel_ref
    assert ttc.load_artifact(key) is tplan.kernels[key]
    from_disk = Toolchain(cache_dir=ttc.cache_dir).load_artifact(key)
    assert from_disk.to_json() == tplan.kernels[key].to_json()
    assert from_disk.from_cache
    assert ttc.load_artifact("0" * 64) is None
    assert Toolchain(cache_dir="").load_artifact(key) is None


def test_spot_check_names_the_reference_sites(plans):
    jplan, tplan = plans
    want = jplan.spot_check(seeds=SPOT_SEEDS, n_sites=len(jplan.sites))
    assert tplan.spot_check(seeds=SPOT_SEEDS, n_sites=len(tplan.sites),
                            device="cpu") == want
    # a reloaded plan spot-checks through the DFG oracle as well
    reloaded = ServePlan.from_json(tplan.to_json())
    assert reloaded.spot_check(seeds=SPOT_SEEDS, device="cpu") == want[:1]


def test_build_with_spot_check_on_the_cpu(toolchains):
    _, ttc = toolchains
    cfg = serve_smoke_config("rwkv6-1.6b")
    plan = build_serve_plan(cfg, toolchain=ttc, spot_check_seeds=SPOT_SEEDS,
                            device="cpu")
    assert plan.to_json() == build_serve_plan(
        cfg, toolchain=ttc, spot_check=False).to_json()


def test_spot_check_needs_a_device_without_cuda(plans, toolchains,
                                                monkeypatch):
    _, tplan = plans
    _, ttc = toolchains
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.spot_check()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_plan(serve_smoke_config("llama3.2-1b"), toolchain=ttc)


def test_exec_model_latencies_equal_the_reference(plans):
    jplan, tplan = plans
    for overhead in (0.0, 1e-3):
        jem = JaxExecModel(jplan, overhead_s=overhead)
        tem = CGRAExecutionModel(tplan, overhead_s=overhead)
        for n in range(0, 70):
            assert tem.decode_step_s(n) == jem.decode_step_s(n)
            assert tem.prefill_s(n) == jem.prefill_s(n)


# ------------------------------------------------------- serving under plans
@pytest.mark.parametrize("arch_id", SMOKE)
def test_traffic_report_under_the_plan_byte_equal(arch_id, toolchains):
    jtc, ttc = toolchains
    jcfg, tcfg = _configs(arch_id, smoke=True)
    kw = dict(seed=2, n_requests=8, arrival_rate=200.0, prompt_len=(3, 20),
              max_new=(2, 7))
    jm = jax_build(jcfg)
    want = jax_run_traffic(
        JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), batch=3, max_len=16,
                  exec_model=JaxExecModel(jax_build_plan(
                      jcfg, toolchain=jtc, spot_check=False))),
        JaxTraffic(**kw), jcfg.vocab)
    tm = build_model(tcfg, device="cpu")
    got = run_traffic(
        Engine(tm, tm.init(torch.Generator().manual_seed(0)), batch=3,
               max_len=16, device="cpu",
               exec_model=CGRAExecutionModel(build_serve_plan(
                   tcfg, toolchain=ttc, spot_check=False))),
        TrafficConfig(**kw), tcfg.vocab)
    assert report_json(got) == jax_report_json(want)
    assert got["truncated"] > 0 and got["served"] == 8


def test_bench_serve_decode_rows_equal_the_committed_ones():
    with open(COMMITTED, encoding="utf-8") as f:
        want = json.load(f)["rows"]
    assert bench_serve_decode(device="cpu") == want
    assert [r["derived"]["tokens_per_s"] for r in want] == [36.680016,
                                                            40.743563]


def test_engine_import_loads_no_toolchain():
    """``serve`` exports the plan and the traffic harness lazily: importing
    the engine alone loads no part of the CGRA toolchain."""
    code = ("import sys, repro_torch.serve.engine; "
            "assert 'repro_torch.core.toolchain' not in sys.modules; "
            "import repro_torch.serve as s; s.ServePlan; s.run_traffic; "
            "assert 'repro_torch.core.toolchain' in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
