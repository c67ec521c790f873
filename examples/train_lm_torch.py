"""End-to-end training driver of the PyTorch port: train a ~100M-param
llama-style model for a few hundred steps with the port's substrate --
the sharded data pipeline with its prefetcher, AdamW (fp32 master), remat,
and async checkpointing with resume.

The same model, flags, print lines and checkpoint directory as
``examples/train_lm.py``: a checkpoint either script writes resumes in
the other.  Resuming starts at the restored state's own step counter (the
number of updates it holds), so a resumed run takes the same steps on
the same batches as an uninterrupted one; the reference restarts at the
checkpoint's label, one step earlier, and replays that batch.

The model trains on ``--device``: by default the CUDA card (with no card
the script raises), ``--device cpu`` for the host.  A resumed run equals
an uninterrupted one bit for bit where the device's algorithms are
deterministic: on CUDA run it under ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
with ``torch.use_deterministic_algorithms(True)``.

Run:  python examples/train_lm_torch.py --steps 200
      python examples/train_lm_torch.py --tiny --device cpu
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       TokenSource)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.train import optimizer as optim  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)


def small_100m(tiny: bool = False):
    """~100M-param member of the llama3.2 family (tiny: ~23M CI variant)."""
    cfg = get_config("llama3.2-1b")
    if tiny:
        return dataclasses.replace(
            cfg, n_layers=6, d_model=512, n_heads=8, n_kv_heads=4,
            head_dim=64, d_ff=1536, vocab=8192, dtype=torch.float32)
    return dataclasses.replace(
        cfg, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=16384, dtype=torch.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="~23M CI variant (default is ~100M)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = small_100m(tiny=args.tiny)
    model = build_model(cfg, device=device)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"model: {cfg.name} variant, {n_params/1e6:.1f}M params")

    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        print(f"resuming from checkpoint step {latest}")
        state = ckpt.restore(latest, state)
        start = state.opt.step

    opt_cfg = optim.OptConfig(lr=3e-4, warmup_steps=20,
                              total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)

    data = TokenSource(DataConfig(seq_len=args.seq,
                                  global_batch=args.batch, vocab=cfg.vocab))
    prefetch = Prefetcher(data, start_step=start)

    metrics = None
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            _, batch = next(prefetch)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss={float(metrics['loss']):.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}  "
                      f"lr={float(metrics['lr']):.2e}  "
                      f"({(time.time()-t0):.0f}s)", flush=True)
            if i and i % args.ckpt_every == 0:
                ckpt.save(i, state)      # async, off the critical path
    finally:
        prefetch.close()
        ckpt.wait()
    ckpt.save(args.steps, state, blocking=True)
    final = "n/a" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"done: {args.steps} steps in {time.time()-t0:.0f}s; "
          f"final loss {final}")


if __name__ == "__main__":
    main()
