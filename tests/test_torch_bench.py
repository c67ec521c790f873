"""The port's kernel micro-benchmark (``repro_torch.bench``), the
counterpart of benchmarks/run.py's ``bench_kernel_micro``: its rows'
schema and names, its refusal to run on the CPU unasked, and that on the
CPU it calls the plain versions and launches no kernel."""
import math

import pytest
import torch

from repro_torch import bench
from repro_torch.kernels.conv2d_os.ops import conv2d_os
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.gemm_os.ops import gemm_os
from repro_torch.kernels.qgemm_int8.ops import qgemm_int8

NAMES = ["gemm_os_256_torch", "decode_attn_torch", "gemm_os_ffn_in_torch",
         "conv2d_os_edge_torch", "qgemm_int8_ffn_in_torch"]
OPS = {"gemm_os": gemm_os, "decode_attn": decode_attn,
       "conv2d_os": conv2d_os, "qgemm_int8": qgemm_int8}


# The same rows at a size the CPU's plain versions run in a moment
SMOKE_SHAPES = dict(gemm=(16, 64, 96), conv=(2, 10, 10, 4, 8, 3))


def test_bench_rows_on_cpu(monkeypatch):
    monkeypatch.setattr(bench, "SHAPES", SMOKE_SHAPES)
    before = {name: op.launches for name, op in OPS.items()}
    rows = bench.bench_kernel_micro("cpu")
    assert [r["name"] for r in rows] == NAMES
    calls = bench.ITERS["cpu"] + 1
    for r in rows:
        assert set(r) == {"name", "us", "derived"}
        assert math.isfinite(r["us"]) and r["us"] >= 0
        assert r["derived"]["kernel"] in OPS
        assert r["derived"]["calls"] == calls
    assert {name: op.launches for name, op in OPS.items()} == before
    M, K, N = SMOKE_SHAPES["gemm"]
    assert rows[2]["derived"]["flops"] == 2 * M * K * N


def test_full_shapes_are_the_named_sites():
    """llama3.2-1b's ffn_in GEMM in prefill (K = d_model 2048, N = d_ff
    8192, one of the site's two GEMMs, gate and up), and the Table-I CONV:
    64 x 64 out of a 66 x 66 image."""
    assert bench.SHAPES["gemm"] == (1024, 2048, 8192)
    n, H, W, Cin, Cout, K = bench.SHAPES["conv"]
    assert (H - K + 1, W - K + 1, Cout, K) == (64, 64, 64, 3)


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_kernel_micro()


def test_cgra_bench_rows_on_cpu(monkeypatch):
    """The CGRA flow's rows, the counterparts of benchmarks/run.py's
    simulator_gemm and verify_batched, on the CPU at a small seed batch
    over two kernels of the set."""
    from repro_torch.core import kernels_lib
    from repro_torch.frontend import library

    sim, = bench.bench_sim_throughput("cpu")
    assert sim["name"] == "simulator_gemm_torch"
    assert sim["us"] > 0 and sim["derived"]["cycles"] > 0
    assert sim["derived"]["cycles_per_s"] > 0
    table1, dsl = kernels_lib.table1_kernels, library.dsl_kernels
    monkeypatch.setattr(bench, "VERIFY_SEEDS", (0, 1))
    monkeypatch.setattr(kernels_lib, "table1_kernels", lambda **kw: {
        "GEMM": table1(**kw)["GEMM"]})
    monkeypatch.setattr(library, "dsl_kernels", lambda *a: {
        "requant-int8": dsl(*a)["requant-int8"]})
    ver, = bench.bench_verify_batched("cpu")
    assert ver["name"] == "verify_batched_torch"
    d = ver["derived"]
    assert (d["kernels"], d["batch"], d["verifies"]) == (2, 2, 4)
    assert d["batch_verifies_per_s"] > 0 and d["sim_cache_entries"] >= 1


def test_cgra_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for row in (bench.bench_sim_throughput, bench.bench_verify_batched):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            row()


@pytest.fixture
def two_kernels(monkeypatch):
    """The verification set cut to GEMM and requant-int8."""
    from repro_torch.core import kernels_lib
    from repro_torch.frontend import library
    table1, dsl = kernels_lib.table1_kernels, library.dsl_kernels
    monkeypatch.setattr(kernels_lib, "table1_kernels", lambda **kw: {
        "GEMM": table1(**kw)["GEMM"]})
    monkeypatch.setattr(library, "dsl_kernels", lambda *a: {
        "requant-int8": dsl(*a)["requant-int8"]})


def test_isa_and_check_rows_on_cpu(two_kernels):
    """isa_export_torch, isa_xval_torch and check_static_torch, with the
    JAX package's derived keys, over two kernels of the set."""
    exp, xval = bench.bench_isa_export("cpu")
    assert (exp["name"], xval["name"]) == ("isa_export_torch",
                                           "isa_xval_torch")
    assert set(exp["derived"]) == {"kernels", "insns", "bytes",
                                   "insns_per_s"}
    assert set(xval["derived"]) == {"kernels", "seeds", "kernels_per_s"}
    assert exp["derived"]["kernels"] == xval["derived"]["kernels"] == 2
    assert exp["us"] > 0 and xval["us"] > 0
    chk, = bench.bench_check_static("cpu")
    assert chk["name"] == "check_static_torch"
    d = chk["derived"]
    assert set(d) == {"kernels", "diagnostics", "kernels_per_s",
                      "verify_us", "verify_ratio"}
    assert (d["kernels"], d["diagnostics"]) == (2, 0)


def test_dse_rows_on_cpu(monkeypatch):
    """dse_sweep_torch over one tiny variant and two suite kernels, and
    dse_search_torch over two points, two kernels and two seeds."""
    from repro_torch.dse import explore, space
    tiny = space.tiny_space
    monkeypatch.setattr(space, "tiny_space", lambda: tiny()[:1])
    monkeypatch.setattr(explore, "SUITE_KERNELS", ("GEMM", "requant-int8"))
    head, row = bench.bench_dse_sweep("cpu")
    assert head["name"] == "dse_sweep_torch" and head["us"] > 0
    d = head["derived"]
    assert (d["variants"], d["verified"], d["kernels"], d["frontier"]) == \
        (1, 1, 2, 1)
    assert row["name"] == tiny()[0].name
    assert row["derived"]["mapped"] == 2 and row["derived"]["pareto"] == 1

    monkeypatch.setattr(bench, "SEARCH_POINTS", 2)
    monkeypatch.setattr(bench, "SEARCH_KERNELS", ("GEMM", "requant-int8"))
    monkeypatch.setattr(bench, "SEARCH_SEEDS", (0, 1))
    row, = bench.bench_dse_search("cpu")
    assert row["name"] == "dse_search_torch"
    d = row["derived"]
    assert (d["points"], d["kernels"], d["seeds"], d["units"]) == \
        (2, 2, 2, 4)
    assert d["builds_stacked"] <= d["builds_exhaustive"]
    assert row["us"] > 0 and d["exhaustive_us"] > 0


def test_tool_rows_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for row in (bench.bench_isa_export, bench.bench_check_static,
                bench.bench_dse_sweep, bench.bench_dse_search):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            row()
