"""Where one step of ``examples/train_lm_torch.py`` spends its time, on the
card: the example's model (``small_100m``), batch and optimizer, with
deterministic algorithms on (as a resumable run needs them) and off.

For each setting it times, over ``--steps`` steps after a warm-up, with
the card synchronised at both ends:
  * ``loop``: the example's own loop body (the prefetcher's next batch,
    its copy to the card, the train step);
  * ``step``: the train step on a batch already on the card;
  * ``fwd_bwd``: the loss and its backward alone;
  * ``opt``: the AdamW update alone (``optimizer.apply``).
Then ``torch.profiler`` records ``--profile-steps`` train steps (with
deterministic algorithms on): the card's busy time a step against the
wall time, kernel launches a step, and the ops that take most of the
card's time and of the host's.

Run:  python examples/profile_train_lm_torch.py [--tiny] [--steps 20]
The last line printed is a JSON object of the figures.
"""
import argparse
import json
import os
import runpy
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       TokenSource)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.train import optimizer as optim  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_loss_fn, make_train_step)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, steps: int, device) -> float:
    """ms a call of ``fn`` over ``steps`` calls, the card synchronised at
    both ends."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    _sync(device)
    return 1e3 * (time.perf_counter() - t0) / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; on the CPU "
                    "the card's figures are 0)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    example = runpy.run_path(os.path.join(HERE, "train_lm_torch.py"),
                             run_name="profile")
    cfg = example["small_100m"](tiny=args.tiny)
    model = build_model(cfg, device=device)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0))
    opt_cfg = optim.OptConfig(lr=3e-4, warmup_steps=20, total_steps=10**6)
    step_fn = make_train_step(model, opt_cfg)
    loss_fn = make_loss_fn(model)
    prefetch = Prefetcher(TokenSource(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab)))
    fixed = {k: torch.from_numpy(v).to(device)
             for k, v in next(prefetch)[1].items()}
    named = dict(state.params.named_parameters())
    box = {"state": state}

    def loop():
        _, batch = next(prefetch)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        box["state"], _m = step_fn(box["state"], batch)

    def step():
        box["state"], _m = step_fn(box["state"], fixed)

    def fwd_bwd():
        loss, _m = loss_fn(box["state"].params, fixed)
        loss.backward()

    def opt():
        grads = {n: p.grad for n, p in named.items()}
        _p, new, _m = optim.apply(opt_cfg, grads, box["state"].opt, named)
        box["state"] = box["state"]._replace(opt=new)

    out = {"model": cfg.name, "params_m": round(sum(
        p.numel() for p in named.values()) / 1e6, 1),
           "batch": args.batch, "seq": args.seq,
           "card": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu"}
    try:
        for det in (True, False):
            torch.use_deterministic_algorithms(det)
            for _ in range(3):
                step()
            key = "deterministic" if det else "default"
            out[key] = {name: round(_timed(fn, args.steps, device), 3)
                        for name, fn in (("loop", loop), ("step", step),
                                         ("fwd_bwd", fwd_bwd), ("opt", opt))}
            print(f"[{key}] ms a call: {out[key]}", flush=True)

        torch.use_deterministic_algorithms(True)
        from torch.profiler import ProfilerActivity, profile
        step()
        _sync(device)
        n = args.profile_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            _sync(device)
            wall = 1e3 * (time.perf_counter() - t0) / n
        events = prof.key_averages()

        def device_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        busy = sum(device_us(e) for e in events) / 1e3 / n
        launches = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC",
                                    "cuLaunchKernelEx")) / n
        top_dev = sorted(events, key=device_us, reverse=True)[:10]
        top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:10]
        out["profile"] = {
            "wall_ms": round(wall, 3), "device_busy_ms": round(busy, 3),
            "device_busy_share": round(busy / wall, 4),
            "launches_a_step": launches,
            "top_device_ms": [(e.key[:60], round(device_us(e) / 1e3 / n, 3),
                               e.count // n) for e in top_dev],
            "top_host_ms": [(e.key[:60],
                             round(e.self_cpu_time_total / 1e3 / n, 3),
                             e.count // n) for e in top_cpu]}
        for k, v in out["profile"].items():
            print(f"[profile] {k}: {v}", flush=True)
    finally:
        prefetch.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
