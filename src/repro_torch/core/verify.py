"""Functional verification flow (paper section IV-C).

Morpher instruments the application to record live-in variables (arrays,
outer-loop iteration variables) and live-out arrays by running it on a
general-purpose processor, then checks the post-simulation memory content
against the expected results.  The same three-step contract here:

  1. *test-data generation*: initialize bank images, record the live-in
     values of every host invocation, and compute expected live-outs with
     the kernel's golden (numpy) model;
  2. additionally cross-check the DFG itself by sequential dataflow
     execution (`DFG.reference_execute`) — this separates "the DFG is the
     right program" from "the mapping executes the DFG correctly";
  3. simulate the mapped configuration cycle-by-cycle and compare the
     final memory images word-for-word.

The canonical entry point is ``Toolchain.compile(spec).verify(seed)``
(`repro_torch.core.toolchain`); this module provides the test-data generator and
the DFG-semantics cross-check it uses.  It imports no torch: the batched DFG oracle
(``repro_torch.core.refexec``) is loaded when a batched check first runs.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .kernels_lib import KernelSpec


def xval_enabled() -> bool:
    """Opt-in second oracle: ``MORPHER_XVAL=1`` routes every verify through
    the exported instruction stream + standalone interpreter
    (``repro_torch.isa.xval``) in addition to the simulator comparison, so
    a verify pass additionally certifies the deployment artifact; its
    simulations run on the verify's own ``device``."""
    return os.environ.get("MORPHER_XVAL", "") == "1"


def check_enabled() -> bool:
    """Opt-in static gate: ``MORPHER_CHECK=1`` runs the
    ``repro_torch.check`` static legality checker at the top of every
    verify, before any simulation (and as a DSE pre-screen).  Clean
    compiled artifacts must be diagnostic-free, so under this gate a
    verify additionally certifies the artifact's structural/temporal
    legality without extra simulation."""
    return os.environ.get("MORPHER_CHECK", "") == "1"


@dataclass
class TestData:
    init_banks: Dict[str, np.ndarray]
    expected_banks: Dict[str, np.ndarray]


@dataclass
class TestDataBatch:
    """All test vectors of one batched verification up front: bank images
    stacked along a leading seed axis, one row per seed."""
    seeds: List[int]
    init_banks: Dict[str, np.ndarray]       # [batch, words]
    expected_banks: Dict[str, np.ndarray]   # [batch, words]

    def init_row(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.init_banks.items()}


def generate_test_data(spec: KernelSpec, seed: int = 0) -> TestData:
    rng = np.random.default_rng(seed)
    init = spec.init_banks(rng)
    expected = spec.golden(init)
    return TestData(init_banks=init, expected_banks=expected)


def generate_test_data_batch(spec: KernelSpec,
                             seeds: Sequence[int]) -> TestDataBatch:
    """Test vectors for every seed, stacked for the batched engine.

    Each row is drawn from that seed's own rng stream — bit-identical to
    ``generate_test_data(spec, seed)`` — so batched and sequential verify
    see the very same images; the numpy golden models are cheap, it is the
    DFG oracle and the simulator that are batch-vectorized downstream.
    """
    if not len(seeds):
        return TestDataBatch(seeds=[], init_banks={}, expected_banks={})
    datas = [generate_test_data(spec, s) for s in seeds]
    names = list(datas[0].init_banks)
    return TestDataBatch(
        seeds=list(seeds),
        init_banks={k: np.stack([np.asarray(d.init_banks[k])
                                 for d in datas]) for k in names},
        expected_banks={k: np.stack([np.asarray(d.expected_banks[k])
                                     for d in datas]) for k in names})


def reference_banks(dfg, init_banks, invocations, mapped_iters: int,
                    bits: int) -> Dict[str, list]:
    """Fold sequential DFG reference execution over all invocations — the
    closure-free oracle shared by the DFG cross-check and deserialized-
    artifact verification."""
    banks = {k: [int(x) for x in v] for k, v in init_banks.items()}
    for inv in invocations:
        banks = dfg.reference_execute(mapped_iters, banks, inv, bits=bits)
    return banks


def reference_banks_batch(dfg, init_banks, invocations, mapped_iters: int,
                          bits: int, device=None) -> Dict[str, np.ndarray]:
    """``reference_banks`` vectorized over the leading seed axis of
    ``init_banks`` ([batch, words] per bank) — one oracle pass for the
    whole batch and invocation sweep instead of one per (seed,
    invocation), so the oracle does not become the bottleneck of batched
    verification.  The heavy lifting runs on the torch DFG executor
    (``repro_torch.core.refexec``) on ``device`` (``None``: the CUDA card);
    ``DFG.reference_execute_batch`` is its bit-identical numpy reference
    (pinned by tests)."""
    from .refexec import reference_execute_torch
    return reference_execute_torch(dfg, mapped_iters, init_banks,
                                   invocations, bits, device=device)


def check_dfg_semantics(spec: KernelSpec, data: TestData) -> None:
    """Step 2: sequential DFG execution must match the golden model."""
    banks = reference_banks(spec.dfg, data.init_banks, spec.invocations,
                            spec.mapped_iters, spec.arch.datapath_bits)
    for name, exp in data.expected_banks.items():
        got = np.asarray(banks[name])
        if not np.array_equal(got, exp):
            bad = np.nonzero(got != np.asarray(exp))[0][:8]
            raise AssertionError(
                f"{spec.name}: DFG reference mismatch in {name} at words "
                f"{bad.tolist()}: got {got[bad]}, want {np.asarray(exp)[bad]}")


def check_dfg_semantics_batch(spec: KernelSpec, data: TestDataBatch,
                              device=None) -> None:
    """Step 2 over a whole seed batch in one vectorized oracle pass (on
    ``device``; ``None``: the CUDA card)."""
    banks = reference_banks_batch(spec.dfg, data.init_banks,
                                  spec.invocations, spec.mapped_iters,
                                  spec.arch.datapath_bits, device=device)
    for name, exp in data.expected_banks.items():
        got = np.asarray(banks[name])
        exp = np.asarray(exp)
        if not np.array_equal(got, exp):
            row = int(np.nonzero(got != exp)[0][0])
            bad = np.nonzero(got[row] != exp[row])[0][:8]
            raise AssertionError(
                f"{spec.name}: DFG reference mismatch for seed "
                f"{data.seeds[row]} in {name} at words {bad.tolist()}: "
                f"got {got[row][bad]}, want {exp[row][bad]}")
