"""The port's batched DFG oracle (``repro_torch.core.refexec``) on the CPU
against the JAX package's (``reference_execute_jax``) and the numpy batch
interpreter (``DFG.reference_execute_batch``), word for word: on the
kernels the JAX package pins its own oracles with, at their test data,
and on a reloaded artifact's random bank images."""
import numpy as np
import pytest

from repro.core.kernels_lib import table1_kernels as ref_table1
from repro.core.refexec import reference_execute_jax
from repro.frontend.library import dsl_kernels as ref_dsl
from repro_torch.core.kernels_lib import table1_kernels
from repro_torch.core.refexec import reference_execute_torch
from repro_torch.core.toolchain import CompiledKernel, Toolchain
from repro_torch.core.verify import generate_test_data
from repro_torch.frontend.library import dsl_kernels

SEEDS = [0, 1, 5, 11]
NAMES = ["GEMM", "CONV", "dwconv", "requant-int8"]


@pytest.fixture(scope="module")
def specs():
    return ({**ref_table1(small=True), **ref_dsl()},
            {**table1_kernels(small=True), **dsl_kernels()})


def _three_oracles(ref_dfg, dfg, n_iters, stacked, invocations, bits):
    want = reference_execute_jax(ref_dfg, n_iters, stacked, invocations,
                                 bits)
    numpy = dfg.reference_execute_batch(
        n_iters, {k: np.asarray(v, dtype=np.int64)
                  for k, v in stacked.items()}, invocations, bits=bits)
    got = reference_execute_torch(dfg, n_iters, stacked, invocations, bits,
                                  device="cpu")
    assert sorted(got) == sorted(want) == sorted(numpy)
    for bank in want:
        assert got[bank].dtype == want[bank].dtype == np.int64
        np.testing.assert_array_equal(got[bank], want[bank], err_msg=bank)
        np.testing.assert_array_equal(got[bank], numpy[bank], err_msg=bank)


@pytest.mark.parametrize("name", NAMES)
def test_oracle_matches_jax_and_numpy(specs, name):
    ref, port = specs[0][name], specs[1][name]
    inits = [generate_test_data(port, s).init_banks for s in SEEDS]
    stacked = {k: np.stack([i[k] for i in inits]) for k in inits[0]}
    _three_oracles(ref.dfg, port.dfg, port.mapped_iters, stacked,
                   port.invocations, port.arch.datapath_bits)


def test_oracle_on_reloaded_artifact(specs):
    """A reloaded artifact (no spec) verifies against this oracle on its
    own random bank images; its DFG is the port's, its JAX twin the
    reference's load of the same JSON."""
    from repro.core.toolchain import CompiledKernel as RefCompiledKernel
    text = Toolchain(cache_dir="").compile(specs[1]["GEMM"]).to_json()
    ck, ref = CompiledKernel.from_json(text), RefCompiledKernel.from_json(text)
    assert ck.spec is None
    inits = [ck.random_banks(s) for s in SEEDS]
    stacked = {k: np.stack([i[k] for i in inits]) for k in inits[0]}
    _three_oracles(ref.dfg, ck.dfg, ck.mapped_iters, stacked,
                   ck.invocations, ck.arch.datapath_bits)


def test_oracle_caches_its_plan(specs):
    dfg = specs[1]["requant-int8"].dfg
    spec = specs[1]["requant-int8"]
    init = generate_test_data(spec, 0).init_banks
    stacked = {k: v[None] for k, v in init.items()}
    reference_execute_torch(dfg, spec.mapped_iters, stacked,
                            spec.invocations, 16, device="cpu")
    plan = dfg._torch_refexec_cache
    reference_execute_torch(dfg, spec.mapped_iters, stacked,
                            spec.invocations, 16, device="cpu")
    assert dfg._torch_refexec_cache is plan
