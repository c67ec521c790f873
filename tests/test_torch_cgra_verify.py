"""The port's verify layer (``repro_torch.core.toolchain``): ``verify``,
``verify_batch``, ``verify_stacked`` and ``verify_many`` pass on the CPU;
a corrupted configuration fails naming the seed, with the JAX package's
message word for word; the opt-in gates (``MORPHER_CHECK``,
``MORPHER_XVAL``) pass a clean artifact and refuse a corrupt one; the
fleet fan-out and the instruction-stream and checker entry points give
what the sequential path and the JAX package give; without a card and
without ``device="cpu"`` the entry points raise; and the torch-free
modules load neither torch, JAX nor the JAX package."""
import dataclasses
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.toolchain import CompiledKernel as RefCompiledKernel
from repro_torch.bench import RF_COHORT, rf_cohort_arch
from repro_torch.core import Toolchain, build_gemm, simulate, table1_kernels
from repro_torch.core.refexec import reference_execute_torch
from repro_torch.core.toolchain import CompiledKernel, verify_stacked
from repro_torch.frontend.library import DSL_PROGRAMS, dsl_kernels

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 5]


@pytest.fixture(scope="module")
def gemm():
    return Toolchain(cache_dir="").compile(table1_kernels(small=True)["GEMM"])


def test_verify_and_verify_batch_pass(gemm):
    assert gemm.verify(seed=3, device="cpu") is gemm
    assert gemm.verify_batch(SEEDS, device="cpu") is gemm
    ck = CompiledKernel.from_json(gemm.to_json())
    assert ck.spec is None
    ck.verify(seed=3, device="cpu")
    ck.verify_batch(SEEDS, device="cpu")


def test_empty_seeds_return_self(gemm):
    assert gemm.verify_batch([], device="cpu") is gemm
    assert verify_stacked([gemm], [], device="cpu") == [gemm]


def test_verify_stacked_over_the_rf_cohort():
    tc = Toolchain(cache_dir="")
    cks = [tc.compile(dsl_kernels(rf_cohort_arch(rf))[name])
           for name in ("dwconv", "requant-int8") for rf in RF_COHORT]
    assert verify_stacked(cks, SEEDS, device="cpu") == cks


def test_verify_many_mixes_specs_programs_and_artifacts(gemm):
    tc = Toolchain(cache_dir="")
    spec = build_gemm(TI=4, TK=4, TJ=4, unroll=1)
    pre = tc.compile(spec)
    out = tc.verify_many([pre, DSL_PROGRAMS[0], gemm], seeds=[0, 1],
                         device="cpu")
    assert out[0] is pre and out[2] is gemm
    assert out[1].name == DSL_PROGRAMS[0].name
    assert tc.verify_many([pre], seeds=[0], stacked=True,
                          device="cpu") == [pre]
    assert tc.last_fleet_report is None


def test_corrupted_config_names_the_seed_like_the_reference(gemm):
    text = gemm.to_json()
    ck, ref = CompiledKernel.from_json(text), RefCompiledKernel.from_json(text)
    ck.cfg.imm[:] = ck.cfg.imm + 1          # corrupt every immediate
    ref.cfg.imm[:] = ref.cfg.imm + 1
    with pytest.raises(AssertionError, match="seed=") as got:
        ck.verify_batch([0, 1], device="cpu")
    with pytest.raises(AssertionError) as want:
        ref.verify_batch([0, 1])
    assert str(got.value) == str(want.value)


def _stores_never_valid(ck):
    """``ck``'s instruction stream with every store's validity window
    pushed past the end of time: the interpreter then diverges."""
    from repro_torch.isa import CSV_NAME, MANIFEST_NAME, encode_kernel
    from repro_torch.isa.interp import parse_stream
    art = encode_kernel(ck)
    lines = art[CSV_NAME].split("\n")
    col = {c: i for i, c in enumerate(lines[0].split(","))}
    out = [lines[0]]
    for ln in lines[1:-1]:
        v = ln.split(",")
        if v[col["opcode"]] == "store":
            v[col["tstart"]] = "1000000"
        out.append(",".join(v))
    return parse_stream("\n".join(out) + "\n",
                        json.loads(art[MANIFEST_NAME]))


@pytest.mark.parametrize("env", ["MORPHER_CHECK", "MORPHER_XVAL"])
def test_verify_gates_pass_clean_and_refuse_corrupt(gemm, env, monkeypatch):
    """Each gate passes the clean artifact through all three verify entry
    points, and refuses a corrupt one: ``MORPHER_CHECK=1`` statically
    (naming the rule) before anything is simulated, ``MORPHER_XVAL=1``
    when the interpreter diverges from the simulator."""
    from repro_torch.check.mutate import mutate_one
    from repro_torch.core import simulator
    from repro_torch.isa import xval

    monkeypatch.setenv(env, "1")
    assert gemm.verify(device="cpu") is gemm
    assert gemm.verify_batch(SEEDS, device="cpu") is gemm
    assert verify_stacked([gemm], SEEDS, device="cpu") == [gemm]
    if env == "MORPHER_CHECK":
        cfg, _desc = mutate_one(gemm, "store_window", seed=0, index=0)
        bad, want = dataclasses.replace(gemm, cfg=cfg), "CFG-STORE-WINDOW"

        def no_simulation(*a, **kw):
            raise AssertionError("simulated a statically corrupt artifact")
        for name in ("simulate", "simulate_batch", "simulate_multi"):
            monkeypatch.setattr(simulator, name, no_simulation)
    else:
        tampered = _stores_never_valid(gemm)
        monkeypatch.setattr(xval, "stream_for", lambda ck: tampered)
        bad, want = gemm, "diverges"
    for call in (lambda: bad.verify(device="cpu"),
                 lambda: bad.verify_batch(SEEDS, device="cpu"),
                 lambda: verify_stacked([bad], SEEDS, device="cpu")):
        with pytest.raises(AssertionError, match=want):
            call()


def test_fleet_and_stream_tools_match_the_reference(gemm, tmp_path):
    """``fleet=`` fans the compiles out through the supervised runner and
    returns the sequential artifacts; ``export_streams`` writes the JAX
    package's bytes; ``cross_validate`` and ``check`` pass."""
    from repro.core.toolchain import Toolchain as RefToolchain
    from repro_torch.dist.fleet import FleetConfig

    specs = [gemm.spec, build_gemm(TI=4, TK=4, TJ=4, unroll=1)]
    tc = Toolchain(cache_dir="")
    got = tc.compile_many(specs, fleet=FleetConfig(groups=2, timeout_s=120))
    want = Toolchain(cache_dir="").compile_many(specs, jobs=1)
    assert [ck.to_json() for ck in got] == [ck.to_json() for ck in want]
    assert tc.last_fleet_report is not None
    assert tc.last_fleet_report.results is not None
    out = tc.verify_many(specs, seeds=[0], fleet=FleetConfig(groups=2),
                         device="cpu")
    assert [ck.cache_key for ck in out] == [ck.cache_key for ck in got]

    paths = tc.export_streams(gemm, str(tmp_path / "port"))
    ref = RefCompiledKernel.from_json(gemm.to_json())
    ref_paths = RefToolchain(cache_dir="").export_streams(
        ref, str(tmp_path / "ref"))
    assert sorted(paths) == sorted(ref_paths)
    for name in paths:
        assert filecmp.cmp(paths[name], ref_paths[name], shallow=False)
    assert tc.cross_validate(gemm, seeds=(0, 1), device="cpu") is gemm
    assert tc.check(gemm) == []


def test_parallel_compile_matches_sequential(gemm):
    """``jobs`` above 1 fans the compiles out to worker processes (when
    the platform gives a pool): the artifacts are the sequential path's
    byte for byte, and ``verify_many`` forwards ``jobs``."""
    from repro_torch.core import pool

    specs = [gemm.spec, build_gemm(TI=4, TK=4, TJ=4, unroll=1)]
    want = [ck.to_json()
            for ck in Toolchain(cache_dir="").compile_many(specs, jobs=1)]
    for jobs in (2, 8):
        tc = Toolchain(cache_dir="")
        assert [ck.to_json()
                for ck in tc.compile_many(specs, jobs=jobs)] == want
        assert (tc.last_fleet_report is not None) == \
            (pool.shared_pool() is not None)
        tc = Toolchain(cache_dir="")
        out = tc.verify_many(specs, seeds=[0, 1], jobs=jobs, device="cpu")
        assert [ck.to_json() for ck in out] == want


def test_entry_points_need_a_card_unless_told(gemm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init = gemm.random_banks(0)
    stacked = {k: v[None] for k, v in init.items()}
    for call in (lambda: gemm.run(init),
                 lambda: gemm.run_batch([init]),
                 lambda: gemm.verify(),
                 lambda: gemm.verify_batch(SEEDS),
                 lambda: verify_stacked([gemm], SEEDS),
                 lambda: simulate(gemm.cfg, init, gemm.invocations,
                                  gemm.mapped_iters),
                 lambda: reference_execute_torch(
                     gemm.dfg, gemm.mapped_iters, stacked, gemm.invocations,
                     16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_host_modules_load_neither_torch_nor_jax():
    """Mapper worker processes import the toolchain's module: it and every
    module the compile half needs stay free of torch, JAX and the JAX
    package."""
    code = ("import sys; import repro_torch.core.toolchain, "
            "repro_torch.core.verify, repro_torch.core.costmodel, "
            "repro_torch.core.simcache, repro_torch.frontend.library, "
            "repro_torch.core; "
            "from repro_torch.core import Toolchain, table1_kernels; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
