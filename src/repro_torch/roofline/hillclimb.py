"""Perf hillclimbing driver (PyTorch port of
``repro.roofline.hillclimb``): evaluate named variants of a cell and
print before/after roofline-relevant metrics from the full traced step.

    python -m repro_torch.roofline.hillclimb --arch llama3.2-1b \\
        --shape train_4k --variants baseline mb8 logits mb8+logits

``mbN`` sets the train step's microbatches; ``logits`` pins the float32
logits to a vocab-sharded layout (``Shard(vocab)`` on "model").
"""
import argparse
import json
import sys
import time

from ..launch.dryrun import lower_cell
from ..launch.mesh import make_production_mesh, release
from .hlo import collective_bytes, cost_terms

VARIANTS = {
    "baseline": {},
    # gradient-accumulation microbatching: peak activation / microbatches
    "mb4": {"microbatches": 4},
    "mb8": {"microbatches": 8},
    "mb16": {"microbatches": 16},
    # pin fp32 logits/CE to a vocab-sharded layout
    "logits": {"shard_logits": True},
    "mb8+logits": {"microbatches": 8, "shard_logits": True},
    "mb16+logits": {"microbatches": 16, "shard_logits": True},
    # MoE capacity factor (smaller buffers, more drops)
    "cap1.0": {"overrides": {}},
}


def eval_variant(arch, shape, mesh, extra):
    t0 = time.time()
    lowered, _ = lower_cell(arch, shape, mesh, extra=extra or None)
    cost = cost_terms(lowered.trace)
    coll = collective_bytes(lowered.trace)
    return {
        "peak_gb": round((lowered.argument_bytes + lowered.temp_bytes)
                         / 1e9, 2),
        "temp_gb": round(lowered.temp_bytes / 1e9, 2),
        "gflops": round(cost["flops"] / 1e9, 1),
        "gbytes": round(cost["bytes_accessed"] / 1e9, 2),
        "coll_gb": round(coll["total"] / 1e9, 3),
        "compile_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", nargs="+", default=["baseline"])
    ap.add_argument("--device", default=None,
                    help="device type the fake mesh traces (default: the "
                    "CUDA card)")
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=False, device=args.device)
    try:
        for name in args.variants:
            extra = VARIANTS[name]
            try:
                m = eval_variant(args.arch, args.shape, mesh, extra)
                print(json.dumps({"variant": name, **m}), flush=True)
            except Exception as e:  # noqa: BLE001
                print(json.dumps({"variant": name,
                                  "error": f"{type(e).__name__}: {e}"}),
                      flush=True)
    finally:
        release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
