"""The wkv6 backward kernels' routes on the card at one shape (by default
rwkv6-1.6b's training shape, B 2 x T 256 x H 32 x D 64, from a zero
state with no state gradient, as training calls it): the ``parallel``
route at each chunk length of ``--cts`` and the first kernel's route
(the one ``parallel`` replaced), on the same seeded inputs, in bf16 and
float32.  Each is held to float64 autograd through ``wkv6_ref`` (every
gradient within the larger of 1e-4 of its largest |g| and the plain
backward's own error), run twice (bit-equal), timed with CUDA events
over copies of the inputs that L2 cannot hold, and split by kernel
(torch.profiler).  Where this run builds ``csrc/wkv6_backward.cu`` it
prints the compiler's registers, shared memory and spills of each
kernel.

Run on the card:  python examples/bench_wkv6_backward_torch.py
                  [--cts 16,32] [--shape 2,256,32,64]
The last line printed is a JSON object of the figures.
"""
import argparse
import json
import math
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.bench import sleep_cycles_per_ms, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wk  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402

L2_BYTES = 50 * 2 ** 20
REL = 1e-4


def _inputs(shape, dtype, seed, decays=(0.9, 0.999)):
    """r, k, v, w, u, state0 (None), g_out, g_state (None) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, T, H, D = shape
    r, k = (0.5 * torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    v, go = (torch.randn(shape, generator=gen, device="cuda")
             for _ in range(2))
    lo, hi = decays
    w = lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")
    u = 0.3 * torch.randn((H, D), generator=gen, device="cuda")
    return (*(a.to(dtype) for a in (r, k, v, w)), u, None, go.to(dtype),
            None)


def _autograd(args, wide):
    """Gradients of (r, k, v, w, u) by autograd through wkv6_ref, in the
    inputs' dtypes (wide None: the plain backward) or widened."""
    ins = [(a if wide is None else a.to(wide)).detach().requires_grad_()
           for a in args[:5]]
    go = args[6] if wide is None else args[6].to(wide)
    with torch.enable_grad():
        out, _ = wkv6_ref(*ins)
        return torch.autograd.grad(out, ins, go)


def _worst(got, exact, plain):
    """The worst |err| / max|g| over the five gradients, the plain
    backward's, and whether each is within the bar."""
    err = pl = 0.0
    ok = True
    for g, e, p in zip(got, exact, plain):
        scale = e.abs().max().item()
        ge = (g.double() - e).abs().max().item()
        pe = (p.double() - e).abs().max().item()
        ok &= ge <= max(REL * scale, pe)
        err, pl = max(err, ge / scale), max(pl, pe / scale)
    return err, pl, ok


def _by_kernel(fn, bufs, calls=10):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(bufs[i % len(bufs)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        name = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
        if us > 0:
            key = name.group(1) if name else e.key[:40]
            out[key] = out.get(key, 0.0) + us / 1e3 / calls
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="2,256,32,64",
                    help="B,T,H,D (default rwkv6-1.6b's training shape)")
    ap.add_argument("--cts", default="16,32",
                    help="chunk lengths of the parallel route to time")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shape = tuple(int(x) for x in args.shape.split(","))
    cts = [int(x) for x in args.cts.split(",")]
    for name, log in _build.build_all().items():
        if name == "wkv6_backward":
            print("\n".join("  " + ln for ln in log.splitlines()
                            if "entry function" in ln or "Used" in ln
                            or "spill" in ln))
    card = torch.cuda.get_device_name(0)
    cyc = sleep_cycles_per_ms()
    default_ct = wk.BWD_CHUNK_T
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        nbytes = 9 * math.prod(shape) * dtype.itemsize
        bufs = [_inputs(shape, dtype, seed)
                for seed in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        exact = _autograd(bufs[0], torch.float64)
        plain = _autograd(bufs[0], None)
        runs = [("parallel", ct) for ct in cts]
        runs.append(("chunked" if shape[1] > wk.CHUNK_T else "step",
                     wk.CHUNK_T))
        for kind, ct in runs:
            wk.BWD_CHUNK_T = ct if kind == "parallel" else default_ct

            def call(b, kind=kind):
                return wk.wkv6_backward_cuda(*b, kind=kind)

            got = call(bufs[0])
            again = call(bufs[0])
            equal = all(torch.equal(a, b) for a, b in zip(got[:6],
                                                          again[:6]))
            err, pl, ok = _worst(got[:5], exact, plain)
            ms, host_ms = time_ms([lambda b=b: call(b) for b in bufs],
                                  args.iters, cyc)
            split = _by_kernel(call, bufs)
            row = dict(dtype=str(dtype)[6:], route=kind, ct=ct, ms=ms,
                       host_ms=host_ms, worst=err, plain=pl, held=ok,
                       bit_equal=equal, by_kernel=split)
            rows.append(row)
            print(f"[wkv6_backward] {row['dtype']} {shape} {kind} ct {ct}: "
                  f"{ms:.5f} ms (host {host_ms:.5f}); worst |err| / "
                  f"max|g| {err:.3e} (plain {pl:.3e}) "
                  f"{'held' if ok else 'NOT HELD'}, two calls "
                  f"{'bit-equal' if equal else 'DIFFER'}; by kernel "
                  + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
                  + f" [{card}]")
        wk.BWD_CHUNK_T = default_ct
        del bufs
    print(json.dumps({"card": card, "shape": shape, "rows": rows}))
    if not all(r["held"] and r["bit_equal"] for r in rows):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
