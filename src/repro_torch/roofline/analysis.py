"""Roofline analysis from traced dry-run cells, no hardware (PyTorch port
of ``repro.roofline.analysis``).

Per (arch x shape) cell on the single-pod mesh, derive the three terms:

    compute    = flops / (989e12 bf16 FLOP/s)
    memory     = bytes / (3.35e12 B/s HBM3)
    collective = collective_bytes / (50e9 B/s)

all per device (the counts of ``roofline/hlo.py`` are per device).  The
reference fits two points because XLA's cost analysis counts a scanned
layer once; the port's trace runs every layer, but the same two-point fit
is kept so the two packages' tables are built alike and a cell costs two
one- and two-layer traces, not a full-depth one: trace the model at
n_layers=1 and n_layers=2 -- the difference is one layer's cost under the
production shardings; total = base + L * layer.  (Approximations, as in
the reference: zamba2's shared-attention cadence and deepseek's 3 dense
layers are folded into the layer term.)

MODEL_FLOPS = 6 * N_active * tokens (train) / 2 * N_active * tokens
(inference); the ratio MODEL_FLOPS / counted flops exposes remat and
redundancy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..configs.registry import SHAPES, ShapeCell, get_config, runnable
from ..models.common import ModelConfig
from .hlo import collective_bytes, cost_terms

# NVIDIA H100 SXM5 80GB (the card this port runs on, H100 80GB HBM3 at its
# 700 W power limit), per GPU:
PEAK_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12      # HBM3 bytes/s, H100 SXM datasheet
# The collective term's rate: a 16-wide "model" axis spans two 8-GPU
# NVLink nodes, so its collectives run at the inter-node rate of one
# 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7), 50e9 bytes/s.
ICI_BW = 50e9
CHIPS = 256           # the single-pod 16x16 mesh


def _cell_costs(arch: str, shape: str, mesh,
                n_layers: int) -> Dict[str, float]:
    """Trace at a reduced layer count; return per-device terms."""
    from ..launch.dryrun import lower_cell

    cfg = get_config(arch)
    extra: Dict[str, Any] = {}
    if cfg.moe and cfg.first_k_dense:
        # the layer term must measure the *MoE* layer (58/61 of deepseek):
        # force an all-MoE stack for both fit points
        extra["overrides"] = {"first_k_dense": 0}
    lowered, _meta = lower_cell(arch, shape, mesh, num_layers=n_layers,
                                extra=extra)
    c = cost_terms(lowered.trace)
    coll = collective_bytes(lowered.trace)
    return {"flops": c["flops"], "bytes": c["bytes_accessed"],
            "coll": float(coll["total"])}


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Useful model flops per device: 6 (train) or 2 (inference) x active
    parameters x tokens, over CHIPS."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6 if cell.kind == "train" else 2
    return mult * cfg.params_active * tokens / CHIPS


def analyze_cell(arch: str, shape: str, mesh,
                 full_record: Optional[Dict] = None) -> Dict[str, Any]:
    """Roofline terms for one cell (single-pod).  full_record: the
    dry-run JSON record (for its memory figures)."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    ok, why = runnable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skip",
                "reason": why}

    one = _cell_costs(arch, shape, mesh, 1)
    two = _cell_costs(arch, shape, mesh, 2)
    layer = {k: max(0.0, two[k] - one[k]) for k in one}
    base = {k: max(0.0, one[k] - layer[k]) for k in one}
    L = cfg.n_layers
    total = {k: base[k] + L * layer[k] for k in one}

    t_compute = total["flops"] / PEAK_FLOPS
    t_memory = total["bytes"] / HBM_BW
    t_coll = total["coll"] / ICI_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, cell)
    counted = total["flops"]
    ratio = mf / counted if counted else float("nan")
    bound = max(terms.values())
    # fraction of roofline: useful work / (dominant-term time * peak)
    roofline_frac = (mf / PEAK_FLOPS) / bound if bound else 0.0

    return {
        "arch": arch, "shape": shape, "status": "ok",
        "kind": cell.kind, "n_layers": L,
        "per_device": total,
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_device": mf,
        "model_vs_hlo_flops": round(ratio, 4),
        "roofline_fraction": round(roofline_frac, 4),
        "memory_analysis": (full_record or {}).get("bytes_per_device"),
    }


SUGGESTIONS = {
    "compute": "raise tensor-core occupancy: larger per-device "
               "batch/microbatch, fuse small ops, drop remat on cheap "
               "layers",
    "memory": "cut HBM traffic: bf16 cache/activations, fuse elementwise "
              "chains, output-stationary blocking (gemm_os), "
              "better remat policy",
    "collective": "reshard: move collectives off the critical path, "
                  "overlap via async collectives, reduce TP degree or "
                  "switch reduce-scatter/all-gather placement",
}
