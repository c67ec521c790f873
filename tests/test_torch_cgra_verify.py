"""The port's verify layer (``repro_torch.core.toolchain``): ``verify``,
``verify_batch``, ``verify_stacked`` and ``verify_many`` pass on the CPU;
a corrupted configuration fails naming the seed, with the JAX package's
message word for word; the deferred parts (``MORPHER_CHECK``,
``MORPHER_XVAL``, the fleet, the instruction-stream and checker entry
points) raise ``NotImplementedError``; without a card and without
``device="cpu"`` the entry points raise; and the torch-free modules load
neither torch, JAX nor the JAX package."""
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


@pytest.mark.parametrize("env", ["MORPHER_CHECK", "MORPHER_XVAL"])
def test_verify_gates_are_deferred(gemm, env, monkeypatch):
    monkeypatch.setenv(env, "1")
    for call in (lambda: gemm.verify(device="cpu"),
                 lambda: gemm.verify_batch(SEEDS, device="cpu"),
                 lambda: verify_stacked([gemm], SEEDS, device="cpu")):
        with pytest.raises(NotImplementedError, match="A2.4"):
            call()


def test_fleet_and_stream_tools_are_deferred(gemm):
    tc = Toolchain(cache_dir="")
    with pytest.raises(NotImplementedError, match="A2.4"):
        tc.compile_many([gemm.spec], fleet=object())
    with pytest.raises(NotImplementedError, match="A2.4"):
        tc.verify_many([gemm], fleet=object(), device="cpu")
    for call in (lambda: tc.export_streams(gemm, "unused"),
                 lambda: tc.cross_validate(gemm),
                 lambda: tc.check(gemm)):
        with pytest.raises(NotImplementedError, match="A2.4"):
            call()


def test_parallel_compile_is_deferred(gemm):
    """``jobs`` above 1 asks for the JAX package's parallel compile, which
    is not ported: it raises; 1 and the default take the sequential
    path."""
    tc = Toolchain(cache_dir="")
    for jobs in (2, 8):
        with pytest.raises(NotImplementedError, match="A2.4"):
            tc.compile_many([gemm.spec], jobs=jobs)
        with pytest.raises(NotImplementedError, match="A2.4"):
            tc.verify_many([gemm], jobs=jobs, device="cpu")
    ck, = tc.compile_many([gemm.spec], jobs=1)
    assert ck.to_json() == gemm.to_json()
    assert tc.verify_many([gemm.spec], jobs=1, device="cpu")[0] is ck


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
