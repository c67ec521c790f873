"""The port's roofline layer (``repro_torch.roofline``) against the
reference's: the collective bytes of the same all-gather and all-reduce
(issued on a fake group here, parsed from HLO text there) are equal; the
counter is per device -- an evenly sharded product on the 16x16 mesh
counts the global flops over 256, where ``FlopCounterMode`` counts the
global figure; the two-point layer fit equals a direct trace of a dense
model exactly; ``model_flops`` equals the reference's formula for every
cell; the kernels' shape-only branches report their formulas and launch
nothing; the roofline CLI writes its table; and the hill-climb's
variants keep the reference's names and trace."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.roofline.analysis as ref_analysis
from repro.configs.registry import get_config as ref_get_config
from repro.roofline.hlo import collective_bytes as ref_collective_bytes
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels.conv2d_os.ops import conv2d_os, conv2d_os_cost
from repro_torch.kernels.gemm_os.ops import gemm_os, gemm_os_cost
from repro_torch.kernels.qgemm_int8.ops import qgemm_int8, qgemm_int8_cost
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import fake_mesh, make_production_mesh, release
from repro_torch.roofline import analysis, run
from repro_torch.roofline.hlo import (TraceCounter, collective_bytes,
                                      cost_terms)


@pytest.fixture
def cleanup():
    yield
    release()


def test_collective_bytes_equal_the_reference(cleanup):
    import torch.distributed._functional_collectives as funcol
    hlo = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %x), dimensions={0}
  ROOT %ar = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%sum
"""
    want = ref_collective_bytes(hlo)
    mesh = fake_mesh((8,), ("model",), device="cpu")
    group = mesh.get_group()
    with FakeTensorMode(), TraceCounter() as trace:
        funcol.all_gather_tensor(torch.empty(1, 128, dtype=torch.bfloat16),
                                 0, group)
        funcol.all_reduce(torch.empty(256), "sum", group)
    got = collective_bytes(trace)
    assert got["all-gather"] == want["all-gather"] == 8 * 128 * 2
    assert got["all-reduce"] == want["all-reduce"] == 256 * 4
    assert got["total"] == want["total"]
    assert got["reduce-scatter"] == got["all-to-all"] == \
        got["collective-permute"] == 0


def test_flops_are_per_device(cleanup):
    """(256*4096 x 2048) @ (2048 x 8192): rows on "data", columns on
    "model" -- each device multiplies a 256th of the product."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_production_mesh(device="cpu")
    M, K, N = 256 * 4096, 2048, 8192
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(M // 16, K, dtype=torch.bfloat16),
                               mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(K, N // 16, dtype=torch.bfloat16),
                               mesh, [Replicate(), Shard(1)],
                               run_check=False)
        with TraceCounter() as trace:
            a @ b
        with FlopCounterMode(display=False) as global_count:
            a @ b
    assert cost_terms(trace)["flops"] == 2 * M * K * N / 256
    assert global_count.get_total_flops() == 2 * M * K * N
    assert cost_terms(trace)["bytes_accessed"] == \
        2 * (M // 16 * K + K * N // 16 + M // 16 * N // 16)


def _reduced(monkeypatch, n_layers=None):
    """The dry run and the roofline read each arch's reduced() config (at
    ``n_layers`` layers when given)."""
    import dataclasses
    from repro_torch.launch import dryrun

    def cfg(arch):
        c = get_config(arch).reduced()
        return dataclasses.replace(c, n_layers=n_layers) if n_layers else c
    monkeypatch.setattr(dryrun, "get_config", cfg)
    monkeypatch.setattr(analysis, "get_config", cfg)


def test_two_point_fit_equals_a_direct_count(cleanup, monkeypatch):
    """A dense model's layers cost the same, so base + L x layer from the
    1- and 2-layer traces is the 4-layer trace's count."""
    _reduced(monkeypatch, n_layers=4)
    mesh = fake_mesh((2, 2), ("data", "model"), device="cpu")
    rec = analysis.analyze_cell("llama3.2-1b", "train_4k", mesh)
    assert rec["n_layers"] == 4
    lowered, _ = lower_cell("llama3.2-1b", "train_4k", mesh)
    direct = cost_terms(lowered.trace)
    np.testing.assert_allclose(rec["per_device"]["flops"], direct["flops"],
                               rtol=1e-12)
    np.testing.assert_allclose(rec["per_device"]["bytes"],
                               direct["bytes_accessed"], rtol=1e-12)
    np.testing.assert_allclose(rec["per_device"]["coll"],
                               collective_bytes(lowered.trace)["total"],
                               rtol=1e-12)
    assert rec["status"] == "ok" and rec["dominant"] in (
        "compute", "memory", "collective")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, cell in SHAPES.items():
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                      else 1)
        mult = 6 if cell.kind == "train" else 2
        want = mult * rcfg.params_active * tokens / ref_analysis.CHIPS
        assert analysis.model_flops(cfg, cell) == want


def test_h100_constants():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW,
            analysis.CHIPS) == (989e12, 3.35e12, 50e9, 256)
    assert set(analysis.SUGGESTIONS) == set(ref_analysis.SUGGESTIONS)


def test_table_kernels_shape_only_report_their_formulas():
    before = (gemm_os.launches, conv2d_os.launches, qgemm_int8.launches)
    with FakeTensorMode(), TraceCounter() as trace:
        c = gemm_os(torch.empty(64, 32, dtype=torch.bfloat16),
                    torch.empty(32, 48, dtype=torch.bfloat16),
                    torch.empty(48, dtype=torch.bfloat16),
                    activation="relu", out_dtype=torch.float32)
        y = conv2d_os(torch.empty(2, 9, 9, 8), torch.empty(3, 3, 8, 16))
        q = qgemm_int8(torch.empty(16, 64, dtype=torch.int8),
                       torch.empty(64, 32, dtype=torch.int8),
                       torch.empty(16), torch.empty(32),
                       out_dtype=torch.bfloat16)
    assert (tuple(c.shape), c.dtype) == ((64, 48), torch.float32)
    assert tuple(y.shape) == (2, 7, 7, 16)
    assert (tuple(q.shape), q.dtype) == ((16, 32), torch.bfloat16)
    assert (gemm_os.launches, conv2d_os.launches,
            qgemm_int8.launches) == before
    assert trace.kernels == {"gemm_os": 1, "conv2d_os": 1, "qgemm_int8": 1}
    want = [gemm_os_cost(64, 32, 48, 2, 4, True),
            conv2d_os_cost(2, 9, 9, 8, 3, 3, 16, 4, 4),
            qgemm_int8_cost(16, 64, 32, 2)]
    assert trace.flops == sum(f for f, _ in want)
    assert trace.bytes_accessed == sum(b for _, b in want)


def test_roofline_cli_writes_its_table(tmp_path, capsys, monkeypatch):
    """Two fit points of reduced llama3.2-1b on the 16x16 mesh."""
    _reduced(monkeypatch)
    out = tmp_path / "roofline.json"
    assert run.main(["--cells", "llama3.2-1b:decode_32k",
                     "llama3.2-1b:long_500k", "--device", "cpu",
                     "--dryrun-json", str(tmp_path / "none.json"),
                     "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok", "skip"]
    assert recs[0]["suggestion"] == analysis.SUGGESTIONS[recs[0]["dominant"]]
    assert "| llama3.2-1b | decode_32k |" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_hillclimb_variants(monkeypatch, cleanup):
    """The reference's variant names; ``baseline`` and ``logits`` (the
    float32 logits pinned to Shard(vocab) on "model") trace a reduced
    llama3.2-1b train step on a 2x2 mesh with the same flops."""
    from repro_torch.roofline import hillclimb
    assert list(hillclimb.VARIANTS) == [
        "baseline", "mb4", "mb8", "mb16", "logits", "mb8+logits",
        "mb16+logits", "cap1.0"]
    _reduced(monkeypatch)
    mesh = fake_mesh((2, 2), ("data", "model"), device="cpu")
    got = {name: hillclimb.eval_variant("llama3.2-1b", "train_4k", mesh,
                                        hillclimb.VARIANTS[name])
           for name in ("baseline", "logits")}
    for m in got.values():
        assert set(m) == {"peak_gb", "temp_gb", "gflops", "gbytes",
                          "coll_gb", "compile_s"}
        assert m["gflops"] > 0
    assert got["baseline"]["gflops"] == got["logits"]["gflops"]


def test_wkv6_shape_only_reports_forward_and_backward_formulas():
    """wkv6's shape-only branch under autograd: the forward's formula and
    the gradient's (the reverse pass, plus the chunk states' recompute
    where T spans more than one chunk), nothing launched."""
    from repro_torch.kernels.wkv6.kernel import CHUNK_T
    from repro_torch.kernels.wkv6.ops import (wkv6, wkv6_backward,
                                              wkv6_backward_cost, wkv6_cost)
    before = (wkv6.launches, wkv6_backward.launches)
    for T, with_state0 in ((CHUNK_T, False), (3 * CHUNK_T + 1, True)):
        B, H, D = 2, 3, 16
        with FakeTensorMode(), TraceCounter() as trace:
            ins = [torch.empty(B, T, H, D, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(4)]
            ins.append(torch.empty(H, D, requires_grad=True))
            ins.append(torch.empty(B, H, D, D, requires_grad=True)
                       if with_state0 else None)
            out, _state = wkv6(*ins)
            out.float().sum().backward()
        assert trace.kernels == {"wkv6": 1, "wkv6 backward": 1}
        fwd = wkv6_cost(B, T, H, D, 2, with_state0)
        bwd = wkv6_backward_cost(B, T, H, D, 2, with_state0, False)
        assert bwd[0] == (14 + (3 if T > CHUNK_T else 0)) * B * H * T * D * D
        assert trace.flops >= fwd[0] + bwd[0]
        assert trace.flops - (fwd[0] + bwd[0]) < 1e-3 * bwd[0]
    assert (wkv6.launches, wkv6_backward.launches) == before
