"""CGRA-backed serving example of the PyTorch port: continuous-batching
decode with the Engine, offload plans and the synthetic traffic harness.

Default run admits a few requests and decodes them token-by-token in one
shared batch (KV caches per slot).  With ``--cgra`` the model's GEMM
sites are compiled into a :class:`ServePlan` (every site tiled onto the
target CGRA, one site spot-checked bit-exactly against the
cycle-accurate simulator) and the engine's clock runs on plan-derived
per-step latency.  With ``--traffic`` a seeded Poisson episode drives the
engine — admission under slot pressure with queueing — and reports
tokens/s, per-request latency percentiles and slot occupancy; ``--out``
writes the byte-deterministic ``BENCH_serve_decode.json`` artifact; with
``--cgra --smoke`` and the default traffic its row equals the reference
benchmark's row of the same model.

The model, the engine and the spot check run on ``--device``: by default
the CUDA card (with no card the script raises), ``--device cpu`` for the
host.

Run:  python examples/serve_decode_torch.py
      python examples/serve_decode_torch.py --cgra --traffic --seed 0
      add --smoke --device cpu for the shrunken config on the host
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          serve_smoke_config)
from repro_torch.core import CGRAArch, MapperOptions, Toolchain  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.plan import (CGRAExecutionModel,  # noqa: E402
                                    build_serve_plan)
from repro_torch.serve.traffic import (FixedLatencyModel,  # noqa: E402
                                       TrafficConfig, report_bench_rows,
                                       report_json, run_traffic)


def demo_cfg(arch_id: str, smoke: bool):
    if smoke:
        return serve_smoke_config(arch_id)
    return dataclasses.replace(
        get_config(arch_id), n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, head_dim=32, d_ff=512, vocab=1024,
        dtype=torch.float32)


def load_arch_file(path: str) -> CGRAArch:
    with open(path, "r", encoding="utf-8") as f:
        arch = CGRAArch.from_json(f.read())
    arch.validate()
    return arch


def plain_demo(eng: Engine, vocab: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, size=(8,)),
                    max_new=8) for i in range(3)]
    for r in reqs:
        assert eng.admit(r)
        print(f"admitted request {r.rid} (prompt len {len(r.prompt)})")
    step = 0
    while any(not r.done for r in reqs):
        toks = eng.step()
        step += 1
        print(f"engine step {step}: {toks}")
    for r in reqs:
        print(f"request {r.rid}: generated {r.out}")
    if eng.exec_model is not None:
        print(f"modeled CGRA time: {eng.clock_s * 1e3:.3f} ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--cgra", action="store_true",
                    help="compile a ServePlan and run the engine clock on "
                         "plan-derived CGRA latency (spot-checks one site "
                         "against the cycle-accurate simulator)")
    ap.add_argument("--traffic", action="store_true",
                    help="drive the engine with a seeded Poisson episode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="traffic arrival rate, requests / modeled second")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="shrunken reduced config (CI serve-smoke)")
    ap.add_argument("--arch-file", default=None, metavar="ADL_JSON",
                    help="user-defined CGRA architecture (ADL JSON)")
    ap.add_argument("--out", default=None,
                    help="write BENCH_serve_decode.json + serve_plan.json "
                         "to this directory")
    ap.add_argument("--device", default=None,
                    help="torch device of the model, the engine and the "
                         "spot check (default: the CUDA card; 'cpu' for "
                         "the host)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = demo_cfg(args.arch, args.smoke)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    exec_model = None
    plan = None
    if args.cgra:
        cgra = load_arch_file(args.arch_file) if args.arch_file else None
        tc = Toolchain(arch=cgra, options=MapperOptions())
        t0 = time.time()
        plan = build_serve_plan(cfg, toolchain=tc, spot_check=False)
        print(f"# plan compiled in {time.time() - t0:.1f}s "
              f"(content-addressed cache makes re-runs warm)")
        print(plan.summary())
        checked = plan.spot_check(seeds=(0, 1), device=dev)
        print(f"# spot-checked bit-exact vs cycle-accurate simulator on "
              f"{dev}: {', '.join(checked)}")
        exec_model = CGRAExecutionModel(plan)

    eng = Engine(model, params, batch=args.batch, max_len=args.max_len,
                 exec_model=exec_model, device=dev)
    if not args.traffic:
        plain_demo(eng, cfg.vocab, args.seed)
        print("serve_decode OK")
        return

    if exec_model is None:
        eng.exec_model = FixedLatencyModel()
        print("# no --cgra: traffic clock uses the fixed-latency baseline")
    traffic = TrafficConfig(seed=args.seed, n_requests=args.requests,
                            arrival_rate=args.rate)
    report = run_traffic(eng, traffic, cfg.vocab)
    print(report_json(report), end="")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        # named and keyed as repro_torch.bench.bench_serve_decode names
        # its rows, so a --smoke --cgra row compares byte for byte with the
        # committed benchmarks/results/after/BENCH_serve_decode.json
        extra = {} if plan is None else dict(sites=len(plan.sites),
                                             tiles=len(plan.kernels))
        rows = report_bench_rows(report, name=f"serve_decode_{args.arch}",
                                 **extra)
        path = os.path.join(args.out, "BENCH_serve_decode.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"bench": "serve_decode", "schema": 1,
                       "git_sha": None, "rows": rows}, f, indent=1)
            f.write("\n")
        print(f"# wrote {path}")
        if plan is not None:
            ppath = os.path.join(args.out, "serve_plan.json")
            with open(ppath, "w", encoding="utf-8") as f:
                f.write(plan.to_json())
            print(f"# wrote {ppath}")
    print("serve_decode OK")


if __name__ == "__main__":
    main()
