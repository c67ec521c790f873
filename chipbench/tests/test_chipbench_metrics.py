"""Each metric reader against a hand count on a small, made-up run."""
import math

import pytest

from chipbench import harness, readers
from chipbench.peaks import H100_SXM
from chipbench.trace import DeviceOp, Span, Stretch, base_name, \
    idle_by_host_span

MS = 1_000_000      # ns


class FakeRun(harness.Run):
    def device_kind(self):
        return "NVIDIA H100 80GB HBM3"


def _run(cfg_name, spans, ops=(), window=(0, 100 * MS)):
    run = FakeRun(cell={}, cfg=harness.config(cfg_name), seed=0, seconds=0,
                  trace=True)
    run.spans = spans
    run.window = window
    run.stretch = Stretch(0, 100 * MS, list(ops), len(ops))
    return run


def _op(name, t0, t1, span):
    return DeviceOp(name, t0, t1, True, span.t0, span)


def test_kernel_names_lose_namespace_template_and_arguments():
    assert base_name("void (anonymous namespace)::wkv6_decode_kernel<64>"
                     "(float const*, int)") == "wkv6_decode_kernel"
    assert base_name("decode_merge_kernel(float const*)") == \
        "decode_merge_kernel"
    assert base_name("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::(anonymous namespace)::f<float>, "
                     "std::array<char*, 2ul> >(int, f<float>)") == \
        "vectorized_elementwise_kernel"


def test_wkv6_decode_roofline_by_hand():
    """One step of 64 slots over 24 layers of 32 heads of 64 in float32:
    bytes (5 x 4 B x 131072 + 4 x 2048 + 2 x 4 x 64 x 32 x 4096) per
    layer; the kernels take 2 ms."""
    step = Span("decode_step", 10 * MS, 30 * MS, {"batch": 64})
    ops = [_op("wkv6_decode_kernel", 11 * MS, 12 * MS, step),
           _op("wkv6_decode_kernel", 13 * MS, 14 * MS, step),
           _op("nvjet_gemm", 14 * MS, 20 * MS, step)]
    run = _run("rwkv6-1.6b-fp32", [step], ops)
    per_layer = 5 * 4 * 64 * 32 * 64 + 4 * 32 * 64 + 2 * 4 * 64 * 32 * 4096
    flops = 5 * 64 * 32 * 4096
    bound = max(24 * flops / 495e12, 24 * per_layer / 3.35e12)
    got = harness.metric_module("wkv6_decode_roofline").read(run)
    assert got == pytest.approx(100 * bound / 2e-3)


def test_wkv6_prefill_roofline_by_hand():
    pre = Span("prefill", 10 * MS, 40 * MS, {"tokens": 4096})
    ops = [_op("wkv6_local_kernel", 11 * MS, 12 * MS, pre),
           _op("wkv6_scan_kernel", 12 * MS, 13 * MS, pre),
           _op("wkv6_correct_kernel", 13 * MS, 14 * MS, pre),
           _op("wkv6_backward_kernel", 14 * MS, 20 * MS, pre)]
    run = _run("rwkv6-1.6b-fp32", [pre], ops)
    n = 4096 * 32 * 64
    per_layer = 5 * 4 * n + 4 * 32 * 64 + 4 * 32 * 4096
    bound = max(24 * 5 * 4096 * 32 * 4096 / 495e12, 24 * per_layer / 3.35e12)
    got = harness.metric_module("wkv6_prefill_roofline").read(run)
    assert got == pytest.approx(100 * bound / 3e-3)


def test_decode_attn_roofline_by_hand():
    """Six applications over 64 slots whose lengths add to 20000: K and V
    read at 2 B x 32 heads x 64, q and out, the lengths."""
    step = Span("decode_step", 0, 50 * MS, {"batch": 64, "ctx_all": 20000})
    ops = [_op("decode_split_tc_kernel", 1 * MS, 2 * MS, step),
           _op("decode_merge_kernel", 2 * MS, 3 * MS, step)]
    run = _run("zamba2-1.2b", [step], ops)
    nbytes = 6 * (2 * 20000 * 32 * 64 * 2 + 2 * 64 * 32 * 64 * 2 + 4 * 64)
    flops = 6 * 4 * 20000 * 32 * 64
    bound = max(flops / 989e12, nbytes / 3.35e12)
    got = harness.metric_module("decode_attn_roofline").read(run)
    assert got == pytest.approx(100 * bound / 2e-3)


def test_a_roofline_with_no_kernel_reads_nothing():
    step = Span("decode_step", 0, 50 * MS, {"batch": 64, "ctx_all": 64})
    run = _run("zamba2-1.2b", [step], [_op("gemm", 1 * MS, 2 * MS, step)])
    assert harness.metric_module("decode_attn_roofline").read(run) is None


def test_mfu_serve_by_hand():
    """A decode step of 64 tokens with 6400 context positions and a
    prefill of 100 tokens, logits at its last position, in 0.1 s."""
    cfg = harness.config("zamba2-1.2b")
    f = cfg["flops"]
    spans = [Span("decode_step", 1 * MS, 20 * MS,
                  {"active": 64, "ctx_active": 6400}),
             Span("prefill", 30 * MS, 60 * MS, {"tokens": 100})]
    run = _run("zamba2-1.2b", spans)
    flops = (64 * f["per_token"] + 6400 * f["per_token_per_context"]
             + 100 * f["per_token"] + 5050 * f["per_token_per_context"]
             - 99 * f["head_per_token"])
    got = harness.metric_module("mfu.serve").read(run)
    assert got == pytest.approx(100 * flops / 0.1 / 989e12)


def test_mfu_prefill_by_hand():
    """Two admissions of 4096 and 2048 tokens, logits at their last
    position, in 0.2 + 0.1 s of the window, float32 on the TF32 rate."""
    cfg = harness.config("rwkv6-1.6b-fp32")
    f = cfg["flops"]
    spans = [Span("prefill", 10 * MS, 210 * MS, {"tokens": 4096}),
             Span("prefill", 300 * MS, 400 * MS, {"tokens": 2048}),
             Span("prefill", 1200 * MS, 1300 * MS, {"tokens": 99})]
    run = _run("rwkv6-1.6b-fp32", spans, window=(0, 1000 * MS))
    flops = (6144 * f["per_token"] - 6142 * f["head_per_token"])
    got = harness.metric_module("mfu.prefill").read(run)
    assert got == pytest.approx(100 * flops / 0.3 / 495e12)


def test_config_flop_counts_by_hand():
    m = harness.config("rwkv6-1.6b-fp32")
    d, f, V, L = 2048, 7168, 65536, 24
    per_layer = 4 * d * d + 2 * d * 64 + 2 * d * f
    assert m["flops"]["per_token"] == \
        2 * (L * per_layer + d * V) + L * 5 * 32 * 64 * 64
    assert m["flops"]["head_per_token"] == 2 * d * V
    z = harness.config("zamba2-1.2b")
    d, di, ds, nh, f, V = 2048, 4096, 64, 32, 8192, 32000
    mamba = d * (2 * di + 2 * ds + nh) + di * d
    shared = 4 * d * d + 3 * d * f
    assert z["flops"]["per_token"] == (2 * (38 * mamba + 6 * shared + d * V)
                                       + 38 * 5 * di * ds
                                       + 38 * 2 * 4 * (di + 2 * ds))
    assert z["flops"]["per_token_per_context"] == 6 * 4 * 32 * 64


def test_idle_share_and_gaps_by_hand():
    step = Span("decode_step", 0, 60 * MS, {})
    pre = Span("prefill", 60 * MS, 100 * MS, {})
    ops = [_op("a", 10 * MS, 20 * MS, step), _op("b", 15 * MS, 30 * MS, step),
           _op("c", 70 * MS, 100 * MS, pre)]
    run = _run("zamba2-1.2b", [step, pre], ops)
    assert run.stretch.busy_s() == pytest.approx(0.05)
    got = harness.metric_module("device_idle_share.serve").read(run)
    assert got == pytest.approx(50.0)
    gaps = dict(idle_by_host_span(run.stretch, run.spans))
    assert gaps["decode_step"] == pytest.approx(0.04)   # 0-10, 30-60
    assert gaps["prefill"] == pytest.approx(0.01)       # 60-70


def test_launches_per_step_counts_kernels_of_whole_steps():
    a = Span("decode_step", 1 * MS, 10 * MS, {})
    b = Span("decode_step", 11 * MS, 20 * MS, {})
    late = Span("decode_step", 95 * MS, 120 * MS, {})   # past the stretch
    ops = [_op("k", 2 * MS, 3 * MS, a)] * 3 + [_op("k", 12 * MS, 13 * MS, b)] \
        + [_op("k", 96 * MS, 97 * MS, late)] * 5
    run = _run("zamba2-1.2b", [a, b, late], ops)
    assert harness.metric_module("launches_per_decode_step").read(run) == 2.0


def test_client_side_metrics_by_hand():
    from chipbench.drivers.serve import Served
    run = _run("zamba2-1.2b", [], window=(100 * MS, 1100 * MS))
    reqs = []
    for i, (sent, times) in enumerate([(90, [150, 200, 260]),
                                       (300, [340, 400]),
                                       (1000, [1200])]):
        s = Served(i, None, sent * MS)
        s.times = [t * MS for t in times]
        s.t_first = s.times[0]
        reqs.append(s)
    run.requests = reqs
    assert harness.metric_module("output_tokens_per_s").read(run) == \
        pytest.approx(5 / 1.0)
    ttfts = [60.0, 40.0]                 # the third arrived after the close
    assert harness.metric_module("ttft_p50_ms.chat").read(run) == 50.0
    assert harness.metric_module("ttft_p90_ms").read(run) == \
        pytest.approx(readers.percentile(ttfts, 90))
    assert readers.percentile(ttfts, 90) == pytest.approx(58.0)
    assert harness.metric_module("itl_p95_ms").read(run) == \
        pytest.approx(readers.percentile([50.0, 60.0, 60.0], 95))


def test_percentile_matches_linear_interpolation():
    import numpy as np
    v = [3.0, 1.0, 7.0, 2.0, 9.0, 4.0]
    for q in (0, 50, 90, 95, 100):
        assert readers.percentile(v, q) == pytest.approx(
            float(np.percentile(v, q)))
    assert readers.percentile([], 95) is None
    assert math.isclose(H100_SXM["bf16_flops"], 989e12)


def test_decode_attn_roofline_counts_the_files_attention_applications():
    """The work of a step is the configuration's ``attention_applications``
    times one call: 6 on zamba2-1.2b, as n_layers // attn_every gave; a
    configuration whose attention layers are not periodic states its own
    count."""
    work = harness.metric_module("decode_attn_roofline").work
    cfg = harness.config("zamba2-1.2b")
    m = cfg["model"]
    assert cfg["derived"]["attention_applications"] == \
        m["n_layers"] // m["attn_every"] == 6
    meta = {"batch": 64, "ctx_all": 20000}
    flops, nbytes = work(cfg, meta)
    assert flops == 6 * 4.0 * 20000 * 32 * 64
    assert nbytes == 6 * ((2.0 * 20000 * 32 * 64 + 2 * 64 * 32 * 64) * 2
                          + 4 * 64)
    cfg["derived"]["attention_applications"] = 4
    del m["attn_every"]
    assert work(cfg, meta) == (flops * 4 / 6, nbytes * 4 / 6)
