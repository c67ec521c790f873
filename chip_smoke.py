#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

1. Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a)
   and prints the build time and what ptxas reports.
2. Holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and times kernel, plain version and the closest
   single PyTorch call (a yardstick only; the port never calls it).
3. Serves llama3.2-1b at full width and depth (random weights from a seed)
   through the port's Engine: 12 requests over 8 slots, so slots are
   reused, and checks that every decode step ran the kernel once per
   layer.  Then holds one decode step's logits, kernel-backed, against the
   same step with the plain attention.
4. Prints the kernels as one JSON line, the card's name and power limit,
   and as its last line {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
Any failure exits nonzero; without a card it exits 1 before doing work.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import deque

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM, NVIDIA data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2 ** 20

# Serving shapes: llama3.2-1b, 8 slots of 2048 positions
B, H, HKV, D, S_MAX = 8, 32, 8, 64, 2048
N_REQUESTS = 12
# bf16 outputs of kernel and plain version may land on neighbouring bf16
# values (one step is 2^-7 relative); float32 as tests/test_kernels.py.
KERNEL_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# One full-depth decode step, kernel against plain attention, both bf16:
# where the two round an attention output to neighbouring bf16 values, 16
# layers of random weights carry the difference into the logits.  Measured
# on an H100: 1.3% of the largest logit magnitude (5.7e-2 of 4.3), argmax
# all equal.  Held to 5%.
LOGITS_REL_TOL = 5e-2
PROFILE_STEPS = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``, which spins the card for a number of
    clock cycles."""
    start, end = _events()
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(calls, iters: int, cycles_per_ms: float):
    """(device ms, host ms) per call, cycling through ``calls``, which work
    on distinct buffers so that L2 holds none of them.  Device time is
    taken with CUDA events while a spin kernel queued first keeps the card
    busy until every timed call is queued, so the events see the calls
    back to back and not the host's launch rate."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls:
        c()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    torch.cuda.synchronize()
    start, end = _events()
    torch.cuda._sleep(int(cycles_per_ms * (2 * iters * host_ms + 1)))
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def decode_attn_bound(lengths, dtype):
    """(bound_ms, bound_by): K/V rows up to each length read once, q read,
    output written; 4 flops per (query head, cached element)."""
    n = int(sum(lengths))
    nbytes = (2 * HKV * n * D + 2 * B * H * D) * dtype.itemsize + 4 * B
    flops = 4 * H * n * D
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {sorted(_build.sources())} built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"[build] nvcc -Xptxas -v for {name}:")
        print("\n".join("    " + ln for ln in log.strip().splitlines()
                        if "entry function" in ln or "Used" in ln
                        or "spill" in ln or "error" in ln))


def phase_kernel_check(card: str):
    """decode_attn against its plain version at the serving shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    cyc = sleep_cycles_per_ms()
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for S in (S_MAX, 1000):
            gen = torch.Generator(device="cuda").manual_seed(S)
            ragged = [1, 63, 64, 65, S, S // 2, 129, S - 1]
            cases = [("ragged", ragged)]
            if dtype == torch.bfloat16 and S == S_MAX:
                cases.append(("full", [S] * B))
            kv_bytes = 2 * B * HKV * S * D * dtype.itemsize
            copies = max(2, math.ceil(2 * L2_BYTES / kv_bytes))
            bufs = [tuple(torch.randn(shape, generator=gen, device="cuda")
                          .to(dtype) for shape in
                          ((B, H, D), (B, HKV, S, D), (B, HKV, S, D)))
                    for _ in range(copies)]
            for label, lens_list in cases:
                lens = torch.tensor(lens_list, dtype=torch.int32,
                                    device="cuda")
                q, k, v = bufs[0]
                got = decode_attn(q, k, v, lens)
                torch.cuda.synchronize()
                want = decode_attn_ref(q, k, v, lens)
                err = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dtype]
                ok = bool(torch.allclose(got.float(), want.float(),
                                         rtol=tol, atol=tol))
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]

                def library(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.view(B, H, 1, D), k, v, attn_mask=mask,
                        enable_gqa=True)

                ms, host_ms = time_ms([lambda b=b: decode_attn(*b, lens)
                                       for b in bufs], 200, cyc)
                plain_ms, _ = time_ms([lambda b=b: decode_attn_ref(*b, lens)
                                       for b in bufs], 20, cyc)
                library_ms, _ = time_ms([lambda b=b: library(*b)
                                         for b in bufs], 50, cyc)
                bound_ms, bound_by = decode_attn_bound(lens_list, dtype)
                print(f"[decode_attn] {str(dtype)[6:]} S={S} lengths "
                      f"{label} {lens_list}: max_abs_err {err:.3e} (tol "
                      f"{tol}) kernel {ms:.5f} ms (host {host_ms:.5f} ms "
                      f"per call), plain {plain_ms:.5f} ms, sdpa "
                      f"{library_ms:.5f} ms, bound {bound_ms:.5f} ms "
                      f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound "
                      f"[{card}]")
                if not ok:
                    raise AssertionError(
                        f"decode_attn disagrees with its plain version: "
                        f"{dtype} S={S} max_abs_err {err}")
                if label == "full":
                    entry = dict(
                        name="decode_attn", route="cuda",
                        source="src/repro_torch/csrc/decode_attn.cu",
                        replaces="src/repro/kernels/decode_attn/kernel.py:60",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
            del bufs
    return entry


def phase_serve(card: str):
    """llama3.2-1b, full width and depth, served through the Engine."""
    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {n_params / 1e9:.3f} B parameters ({cfg.dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(model, params, batch=B, max_len=S_MAX)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(64, 1025))),
                    max_new=int(rng.integers(32, 65)))
            for i in range(N_REQUESTS)]

    pending = deque(reqs)
    prefill_s, decode_s, steps, decoded, prompt_tokens = 0.0, 0.0, 0, 0, 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    decode_attn.launches = 0
    while pending or eng.n_active:
        while pending and eng.has_free_slot():
            req = pending.popleft()
            t0 = time.perf_counter()
            if not eng.admit(req):
                raise AssertionError(f"no slot for request {req.rid}")
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
            prompt_tokens += len(req.prompt)
        t0 = time.perf_counter()
        decoded += len(eng.step())
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        steps += 1
    launches = decode_attn.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    if launches != cfg.n_layers * steps:
        raise AssertionError(f"decode_attn launched {launches} times in "
                             f"{steps} decode steps of {cfg.n_layers} layers")
    for r in reqs:
        if not (r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid} ended wrongly: "
                                 f"{len(r.out)}/{r.max_new} tokens")
    print(f"[serve] {N_REQUESTS} requests, {prompt_tokens} prompt tokens, "
          f"{decoded} decoded tokens in {steps} decode steps; decode_attn "
          f"launches {launches} = {cfg.n_layers} x {steps}")
    print(f"[serve] prefill {prefill_s * 1e3:.1f} ms total "
          f"({prompt_tokens / prefill_s:.0f} prompt tokens/s, batch-1 "
          f"prefills); decode {decode_s * 1e3:.1f} ms total, "
          f"{decode_s / steps * 1e3:.2f} ms/step, {decoded / decode_s:.1f} "
          f"tokens/s; peak memory {peak_gib:.2f} GiB [{card}]")

    # One decode step with all slots busy: kernel against plain attention.
    for r in [Request(rid=100 + i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(64, 1025))),
                          max_new=PROFILE_STEPS + 2)
              for i in range(B)]:
        if not eng.admit(r):
            raise AssertionError(f"no slot for request {r.rid}")
    dev = model.device
    toks = torch.from_numpy(eng.last_tok[:, None].astype(np.int64)).to(dev)
    pos = torch.from_numpy(eng.lengths[:, None].astype(np.int64)).to(dev)
    lens = torch.from_numpy(eng.lengths + 1).to(dev)
    saved = [c.clone() for c in eng.caches["dense"]]
    logits, _ = model.decode(params, eng.caches, toks, pos, lens)
    for c, s in zip(eng.caches["dense"], saved):
        c.copy_(s)
    attention.decode_attn = decode_attn_ref
    try:
        plain, _ = model.decode(params, eng.caches, toks, pos, lens)
    finally:
        attention.decode_attn = decode_attn
    logits, plain = logits.float(), plain.float()
    if not (torch.isfinite(logits).all() and logits.shape == (B, 1, cfg.vocab)):
        raise AssertionError(f"decode logits not finite or shaped "
                             f"{tuple(logits.shape)}")
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[serve] decode step, kernel vs plain attention: max_abs_err "
          f"{err:.3e}, max |logit| {scale:.3f}, tol "
          f"{LOGITS_REL_TOL * scale:.3e}, argmax agreement {agree:.3f}")
    if err > LOGITS_REL_TOL * scale:
        raise AssertionError("kernel-backed decode logits disagree with the "
                             "plain-backed ones")
    profile_steps(eng, card)
    return {"decode_attn": launches}


def profile_steps(eng, card: str) -> None:
    """Device busy time and the costliest kernels of a few decode steps
    with all slots busy, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / PROFILE_STEPS
    n_launch = sum(e.count for e in kernels) / PROFILE_STEPS
    print(f"[profile] {PROFILE_STEPS} decode steps, {eng.n_active} slots "
          f"busy: {wall_ms:.2f} ms/step under the profiler, device busy "
          f"{busy_ms:.3f} ms/step in {n_launch:.0f} kernel launches, idle "
          f"share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[profile]   {dev_us(e) / 1e3 / PROFILE_STEPS:.4f} ms/step, "
              f"{e.count / PROFILE_STEPS:.0f} launches/step: {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    entry = phase_kernel_check(card)
    launches = phase_serve(card)
    entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
