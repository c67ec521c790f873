"""Multi-pod dry run: prove the distribution config is coherent without
the hardware (PyTorch port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell and each production mesh
(single-pod 16x16, multi-pod 2x16x16), trace the appropriate step --
the train step, ``prefill`` or ``decode`` -- with DTensor on a fake
process group of 256 or 512 ranks (``launch/mesh.py``) under
``FakeTensorMode``: every input is an abstract DTensor placed by the
sharding rules (``launch/specs.py``), no tensor holds storage, and the
kernels take their shape-only branches.  Record, per device:
  * bytes: the arguments' local shards, the outputs', and the temporaries'
    peak over the trace (``torch.distributed._tools.mem_tracker``);
  * cost: flops / bytes / transcendentals (``roofline/hlo.py``);
  * collective bytes per kind, as DTensor issues them.

"Lowering" here is the trace itself: eager PyTorch has no separate
compile step, so a record's ``compile_s`` is 0.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]
    python -m repro_torch.launch.dryrun --cells zamba2-1.2b:train_4k \
        deepseek-v3-671b:decode_32k --num-layers 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

from ..configs.registry import ARCH_IDS, SHAPES, get_config, runnable
from ..dist.sharding import placements
from ..models.common import ModelConfig
from ..models.zoo import build_model
from ..roofline.hlo import TraceCounter, collective_bytes, cost_terms
from ..train import optimizer as optim
from ..train.step import make_train_step
from . import rules
from .mesh import make_production_mesh, release
from .specs import (abstract_cache, abstract_params, abstract_train_state,
                    decode_input_specs, mesh_device, token_or_embed_spec,
                    train_batch_specs)


class SkipCell(Exception):
    pass


def _tensors(tree: Any) -> list:
    """Every tensor of ``tree``, a module's parameters included."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _local_bytes(tensors: list) -> int:
    """Bytes of the distinct tensors' local shards (this device's)."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            t = getattr(t, "_local_tensor", t)
            total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class Lowered:
    """One traced cell: its counts (``trace``) and bytes per device."""
    trace: TraceCounter
    argument_bytes: int
    output_bytes: int
    temp_bytes: int


def cell_config(arch: str, num_layers: Optional[int] = None,
                extra: Optional[Dict] = None) -> ModelConfig:
    """``arch``'s config with the reference's overrides: ``num_layers``
    (keeping first_k_dense and attn_every consistent) and
    ``extra["overrides"]``."""
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=num_layers,
            first_k_dense=min(cfg.first_k_dense, max(0, num_layers - 1)),
            attn_every=min(cfg.attn_every, num_layers) if cfg.attn_every
            else 0)
    if extra and extra.get("overrides"):
        cfg = dataclasses.replace(cfg, **extra["overrides"])
    return cfg


def lower_cell(arch: str, shape: str, mesh, *, num_layers: Optional[int]
               = None, microbatches: int = 1, extra: Optional[Dict] = None):
    """Trace one (arch, shape) cell on ``mesh``.  num_layers overrides
    cfg.n_layers (used by the roofline two-point fit); ``extra`` holds
    the hill-climb knobs: ``microbatches``, ``shard_logits`` and
    ``overrides``.  Returns (Lowered, meta)."""
    rules.install()
    cfg = cell_config(arch, num_layers, extra)
    cell = SHAPES[shape]
    ok, why = runnable(cfg, cell)
    if not ok:
        raise SkipCell(why)
    model = build_model(cfg, device=mesh_device(mesh))

    with FakeTensorMode():
        if cell.kind == "train":
            logits_spec = None
            if extra and extra.get("shard_logits"):
                dp = tuple(n for n in ("pod", "data")
                           if n in mesh.mesh_dim_names)
                logits_spec = (mesh, placements(
                    (dp if len(dp) > 1 else dp[0], None, "model"), mesh))
            mb = (extra or {}).get("microbatches", microbatches)
            step = make_train_step(model, optim.OptConfig(),
                                   num_microbatches=mb,
                                   logits_spec=logits_spec)
            args = (abstract_train_state(model, mesh),
                    train_batch_specs(cfg, cell, mesh))
            fn = step
        elif cell.kind == "prefill":
            B, T = cell.global_batch, cell.seq_len
            params, _ = abstract_params(model, mesh)
            inputs = token_or_embed_spec(cfg, B, T, mesh)
            lens = torch.empty((B,), dtype=torch.int32,
                               device=mesh_device(mesh))
            args = (params, inputs, lens)
            fn = model.prefill
        else:  # decode
            B, S = cell.global_batch, cell.seq_len
            params, _ = abstract_params(model, mesh)
            caches = abstract_cache(model, B, S, mesh)
            args = (params, caches, *decode_input_specs(cfg, cell, mesh))
            fn = model.decode
        arg_tensors = _tensors(args)
        arg_bytes = _local_bytes(arg_tensors)
        mem = MemTracker()
        mem.track_external(*arg_tensors)
        with implicit_replication(), rules.ModelGaps(), mem, \
                TraceCounter() as trace:
            out = fn(*args)
        peak = sum(snap.get("Total", 0) for snap in
                   mem.get_tracker_snapshot("peak").values())
    out_bytes = _local_bytes(_tensors(out))
    lowered = Lowered(trace, arg_bytes, out_bytes, max(0, peak - arg_bytes))
    return lowered, {"arch": arch, "shape": shape, "kind": cell.kind,
                     "n_layers": cfg.n_layers if num_layers is None
                     else num_layers}


def run_cell(arch: str, shape: str, mesh, mesh_name: str,
             compile_: bool = True,
             num_layers: Optional[int] = None) -> Dict[str, Any]:
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if num_layers is not None:
        rec["n_layers"] = num_layers
    try:
        lowered, _meta = lower_cell(arch, shape, mesh, num_layers=num_layers)
    except SkipCell as e:
        rec.update(status="skip", reason=str(e))
        return rec
    rec["lower_s"] = round(time.time() - t0, 1)
    if not compile_:
        rec["status"] = "lowered"
        return rec
    rec["compile_s"] = 0.0
    rec["bytes_per_device"] = {
        "argument": lowered.argument_bytes,
        "output": lowered.output_bytes,
        "temp": lowered.temp_bytes,
        "peak": lowered.argument_bytes + lowered.temp_bytes,
    }
    rec["cost"] = cost_terms(lowered.trace)
    rec["collective_bytes"] = collective_bytes(lowered.trace)
    rec["status"] = "ok"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", nargs="+", default=None,
                    help="arch:shape pairs, traced in turn")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="trace each cell's config cut to this many layers")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="device type the fake mesh traces (default: the "
                    "CUDA card)")
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [("pod16x16", False), ("pods2x16x16", True)]
    else:
        meshes = [("pods2x16x16" if args.multi_pod else "pod16x16",
                   args.multi_pod)]

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells]
    else:
        assert args.arch and args.shape, "--arch/--shape, --cells or --all"
        cells = [(args.arch, args.shape)]

    results = []
    fails = 0
    try:
        for mesh_name, multi_pod in meshes:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device=args.device)
            for arch, shape in cells:
                try:
                    rec = run_cell(arch, shape, mesh, mesh_name,
                                   num_layers=args.num_layers)
                except Exception as e:  # noqa: BLE001 — report and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                    traceback.print_exc()
                    fails += 1
                results.append(rec)
                print(json.dumps(rec), flush=True)
    finally:
        release()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    print(f"# dry-run: {n_ok} ok, {n_skip} skip, {fails} FAIL "
          f"of {len(results)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
