"""The port's cycle-accurate simulator (``repro_torch.core.simulator``) on
the CPU against the JAX package's, word for word, on the reference's own
artifacts loaded through their JSON: ``simulate``, ``simulate_batch``
(three seeds, padded to the 4-bucket) and ``simulate_multi`` (a cohort of
fabrics with 4, 8 and 16 registers in one 16-register group), with empty
invocations, with the per-cycle store-gate path against the pre-tiled
one, at 8-bit and 32-bit datapaths, and with every store commit checked
to write one word per gated-on lane."""
import dataclasses

import numpy as np
import pytest

import repro.core.simulator as ref_sim
from repro.core.adl import cluster_4x4 as ref_cluster_4x4
from repro.core.kernels_lib import table1_kernels as ref_table1
from repro.core.toolchain import CompiledKernel as RefCompiledKernel
from repro.core.toolchain import Toolchain as RefToolchain
from repro.core.toolchain import _batch_oracle
from repro.core.verify import generate_test_data
from repro.dse import ArchPoint, kernel_suite
from repro.frontend.library import dsl_kernels as ref_dsl
from repro_torch.bench import RF_COHORT
from repro_torch.core import simcache
from repro_torch.core import simulator as sim
from repro_torch.core.toolchain import CompiledKernel

SEEDS = [0, 1, 7]
SET = ["GEMM", "GEMM-U", "GEMM-U-C", "CONV", "CONV-U-C-1", "CONV-U-C-2",
       "dwconv", "avgpool2x2", "gemm-bias-relu", "requant-int8"]


@pytest.fixture(scope="module")
def kernels():
    """{name: (reference artifact with its spec, the port's load of its
    JSON, the seeds' initial images)}."""
    specs = {**ref_table1(small=True), **ref_dsl()}
    cks = RefToolchain(cache_dir="").compile_many([specs[n] for n in SET])
    out = {}
    for name, ck in zip(SET, cks):
        init = [generate_test_data(ck.spec, s).init_banks for s in SEEDS]
        out[name] = (ck, CompiledKernel.from_json(ck.to_json()), init)
    return out


@pytest.fixture(scope="module")
def cohort():
    """{kernel: [(reference artifact, port artifact)] per RF variant}."""
    tc = RefToolchain(cache_dir="")
    out = {}
    for name in ("dwconv", "requant-int8"):
        out[name] = []
        for rf in RF_COHORT:
            arch = ArchPoint(rows=4, cols=4, torus=False, regfile_size=rf,
                             bank_kb=4, banks_per_col=2, het="none").build()
            ck = tc.compile(kernel_suite(arch)[name])
            out[name].append((ck, CompiledKernel.from_json(ck.to_json())))
    return out


def _equal(want, got, label):
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        assert sorted(w) == sorted(g), label
        for bank in w:
            assert g[bank].dtype == np.asarray(w[bank]).dtype, label
            np.testing.assert_array_equal(
                np.asarray(w[bank]), g[bank],
                err_msg=f"{label} row {i} {bank}")


@pytest.mark.parametrize("name", SET)
def test_simulate_batch_matches_reference(kernels, name):
    ref, port, init = kernels[name]
    assert simcache.bucket_batch(len(SEEDS)) == 4
    want = ref_sim.simulate_batch(ref.cfg, init, ref.invocations,
                                  ref.mapped_iters)
    got = sim.simulate_batch(port.cfg, init, port.invocations,
                             port.mapped_iters, device="cpu")
    _equal(want, got, name)


@pytest.mark.parametrize("name", SET)
def test_simulate_matches_reference(kernels, name):
    ref, port, init = kernels[name]
    want = ref_sim.simulate(ref.cfg, init[0], ref.invocations,
                            ref.mapped_iters)
    got = sim.simulate(port.cfg, init[0], port.invocations,
                       port.mapped_iters, device="cpu")
    _equal([want], [got], name)


@pytest.mark.parametrize("name", SET)
def test_per_cycle_gate_matches_pretiled(kernels, name, monkeypatch):
    """Past the tiling cap the store gate is derived from the slot planes
    every cycle instead of tabulated up front: the same words either way,
    and every gated-on lane of a commit writes its own word."""
    ref, port, init = kernels[name]
    built = []
    gates = sim._Gates
    monkeypatch.setattr(sim, "_Gates",
                        lambda *a: built.append(1) or gates(*a))
    monkeypatch.setattr(sim, "_CHECK_STORES", True)
    args = (port.cfg, init, port.invocations, port.mapped_iters)
    tiled = sim.simulate_batch(*args, device="cpu")
    assert built
    monkeypatch.setattr(sim, "_TILE_BYTES_LIMIT", 0)
    built.clear()
    per_cycle = sim.simulate_batch(*args, device="cpu")
    assert not built
    _equal(tiled, per_cycle, name)
    _equal(ref_sim.simulate_batch(ref.cfg, init, ref.invocations,
                                  ref.mapped_iters), per_cycle, name)


def _spy_gates(monkeypatch):
    """The store-gate tables the simulator builds from now on."""
    built = []
    gates = sim._Gates
    monkeypatch.setattr(sim, "_Gates",
                        lambda *a: built.append(gates(*a)) or built[-1])
    return built


@pytest.mark.parametrize("name", SET)
def test_loop_runs_the_exact_cycle_count(kernels, name, monkeypatch):
    """The runner's signature keeps the JAX package's bucketed cycle
    count; the loop runs the kernel's exact one."""
    _, port, init = kernels[name]
    exact = port.cfg.n_cycles(port.mapped_iters)
    built = _spy_gates(monkeypatch)
    simcache.clear()
    sim.simulate_batch(port.cfg, init, port.invocations, port.mapped_iters,
                       device="cpu")
    sig, = simcache._entries
    assert sig.n_cycles == simcache.bucket_cycles(exact)
    assert [sum(len(t) for t in g.table) for g in built] == [exact]


def test_tiling_cap_counts_the_gate_table(kernels, cohort, monkeypatch):
    """The tiling cap is held against the bytes of the gate table itself
    (one bool per store lane, of every stacked row, and cycle): at exactly
    that many bytes the table is built, one byte less and the gate is
    derived each cycle, with the same words."""
    _, port, init = kernels["CONV-U-C-2"]
    stacked = [p for _, p in cohort["dwconv"]]
    inits = [[p.random_banks(s) for s in SEEDS] for p in stacked]
    runs = {
        "single": lambda: [sim.simulate_batch(
            port.cfg, init, port.invocations, port.mapped_iters,
            device="cpu")],
        "stacked": lambda: sim.simulate_multi(
            [(p.cfg, i, p.invocations) for p, i in zip(stacked, inits)],
            stacked[0].mapped_iters, device="cpu")}
    for label, run in runs.items():
        built = _spy_gates(monkeypatch)
        monkeypatch.setattr(sim, "_TILE_BYTES_LIMIT", 1 << 40)
        want = run()
        table, = built
        need = sum(t.numel() * t.element_size() for t in table.table)
        assert need > 0, label
        monkeypatch.setattr(sim, "_TILE_BYTES_LIMIT", need)
        built.clear()
        assert run() and len(built) == 1, label
        monkeypatch.setattr(sim, "_TILE_BYTES_LIMIT", need - 1)
        built.clear()
        got = run()
        assert not built, label
        for w, g in zip(want, got):
            _equal(w, g, label)


@pytest.mark.parametrize("name", SET)
def test_host_planes_match_reference(kernels, name):
    ref, port, _ = kernels[name]
    for rf_pad in (0, simcache.bucket_rf(port.cfg.RF)):
        want = ref_sim._host_planes(ref.cfg, rf_pad)
        got = sim._host_planes(port.cfg, rf_pad)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sim._state_layout(16, 8, 2) == ref_sim._state_layout(16, 8, 2)
    assert sim.stack_signature(port.cfg, port.mapped_iters, 3) == \
        ref_sim.stack_signature(ref.cfg, ref.mapped_iters, 3)


def test_empty_invocations_return_initial_banks(kernels):
    ref, port, init = kernels["GEMM"]
    want = ref_sim.simulate(ref.cfg, init[0], [], ref.mapped_iters)
    got = sim.simulate(port.cfg, init[0], [], port.mapped_iters,
                       device="cpu")
    _equal([want], [got], "simulate")
    got = sim.simulate_batch(port.cfg, init, [], port.mapped_iters,
                             device="cpu")
    _equal(ref_sim.simulate_batch(ref.cfg, init, [], ref.mapped_iters),
           got, "simulate_batch")
    assert sim.simulate_batch(port.cfg, [], port.invocations,
                              port.mapped_iters, device="cpu") == []
    got = sim.simulate_multi([(port.cfg, init, [])], port.mapped_iters,
                             device="cpu")
    want = ref_sim.simulate_multi([(ref.cfg, init, [])], ref.mapped_iters)
    _equal(want[0], got[0], "simulate_multi")


def test_mixed_rf_cohort_matches_reference(cohort, monkeypatch):
    """The RF 4/8/16 variants of a kernel share one 16-register stack
    signature; stacked, each row equals the reference's stacked run and
    the port's own per-config batch."""
    monkeypatch.setattr(sim, "_CHECK_STORES", True)
    for name, pairs in cohort.items():
        sigs = {sim.stack_signature(p.cfg, p.mapped_iters,
                                    len(p.invocations)) for _, p in pairs}
        assert len(sigs) == 1 and sigs.pop()[2] == 16, name
        inits = [_batch_oracle(r, SEEDS, check_dfg=False)[0]
                 for r, _ in pairs]
        want = ref_sim.simulate_multi(
            [(r.cfg, i, r.invocations) for (r, _), i in zip(pairs, inits)],
            n_iters=pairs[0][0].mapped_iters)
        before = simcache.stats()["entries"]
        got = sim.simulate_multi(
            [(p.cfg, i, p.invocations) for (_, p), i in zip(pairs, inits)],
            n_iters=pairs[0][1].mapped_iters, device="cpu")
        assert simcache.stats()["entries"] <= before + 1
        for (_, p), i, w, g in zip(pairs, inits, want, got):
            _equal(w, g, f"{name} {p.arch.name}")
            _equal(sim.simulate_batch(p.cfg, i, p.invocations,
                                      p.mapped_iters, device="cpu"),
                   g, f"{name} {p.arch.name} batch")


def _gemm_artifact(bits):
    """The small Table-I GEMM compiled by the reference for a
    ``bits``-wide cluster_4x4, reloaded through JSON by both packages
    (no spec: the 16-bit golden models do not apply)."""
    arch = dataclasses.replace(ref_cluster_4x4(), datapath_bits=bits)
    ck = RefToolchain(cache_dir="").compile(
        ref_table1(small=True, arch=arch)["GEMM"])
    text = ck.to_json()
    return RefCompiledKernel.from_json(text), CompiledKernel.from_json(text)


def test_8bit_datapath_matches_reference():
    """An 8-bit datapath takes the int32-carrier path with an explicit
    wrap; the reference simulates it too, and both oracles accept it."""
    ref, port = _gemm_artifact(8)
    assert port.spec is None and port.cfg.bits == 8
    init = [port.random_banks(s) for s in SEEDS]
    got = port.run_batch(init, device="cpu")
    assert got[0]["bank0"].dtype == np.int32
    _equal(ref.run_batch(init), got, "8-bit")
    _equal([ref.run(init[0])], [port.run(init[0], device="cpu")], "8-bit")
    stacked = {k: np.stack([b[k] for b in init]) for k in init[0]}
    want = port.dfg.reference_execute_batch(
        port.mapped_iters, stacked, port.invocations, bits=8)
    for bank in port.liveout_banks():
        for i in range(len(SEEDS)):
            np.testing.assert_array_equal(got[i][bank], want[bank][i])
    port.verify_batch(SEEDS, device="cpu")
    ref.verify_batch(SEEDS)


def test_32bit_datapath_matches_numpy_oracle():
    """At 32 bits the int32 carrier's own overflow is the wrap; the port
    equals the numpy DFG oracle (the reference's simulator and JAX oracle
    raise OverflowError there: ROADMAP C8)."""
    _, port = _gemm_artifact(32)
    init = [port.random_banks(s) for s in SEEDS]
    stacked = {k: np.stack([b[k] for b in init]) for k in init[0]}
    want = port.dfg.reference_execute_batch(
        port.mapped_iters, stacked, port.invocations, bits=32)
    got = port.run_batch(init, device="cpu")
    for bank in port.liveout_banks():
        for i in range(len(SEEDS)):
            np.testing.assert_array_equal(got[i][bank], want[bank][i])
    port.verify_batch(SEEDS, device="cpu")


@pytest.mark.parametrize("name", ["requant-int8", "dwconv"])
def test_opcode_outside_the_table_computes_zero_like_reference(kernels,
                                                                name):
    """A corrupt config (an opcode no ALU knows, as the checker's
    ``opcode_clobber`` mutants make) runs as the JAX package runs it: the
    lane's FU output becomes 0."""
    from repro_torch.core.config_gen import MNEMONIC
    ref, port, init = kernels[name]
    live = np.argwhere(np.asarray(ref.cfg.op) > 1)
    s, p = live[len(live) // 2]
    op = np.array(ref.cfg.op)
    op[s, p] = max(MNEMONIC) + 3
    want = ref_sim.simulate_batch(dataclasses.replace(ref.cfg, op=op), init,
                                  ref.invocations, ref.mapped_iters)
    got = sim.simulate_batch(dataclasses.replace(port.cfg, op=op.copy()),
                             init, port.invocations, port.mapped_iters,
                             device="cpu")
    _equal(want, got, name)
    clean = sim.simulate_batch(port.cfg, init, port.invocations,
                               port.mapped_iters, device="cpu")
    assert any(not np.array_equal(g[k], c[k])
               for g, c in zip(got, clean) for k in c)
