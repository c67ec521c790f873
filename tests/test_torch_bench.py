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
