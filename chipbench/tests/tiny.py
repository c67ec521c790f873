"""Tiny CPU versions of the benchmark's configurations and cells, for the
tests: the port's ``ModelConfig.reduced()`` sizes in float32."""
from __future__ import annotations

import copy
from typing import Dict

from chipbench import harness


def tiny_config(name: str) -> Dict:
    cfg = copy.deepcopy(harness.config(name))
    small = harness.model_config(cfg).reduced()
    m = cfg["model"]
    for key in list(m):
        value = getattr(small, key)
        m[key] = "float32" if key == "dtype" else value
    d, H = m["d_model"], m["n_heads"]
    if cfg["family"] == "rwkv6":
        cfg["derived"] = {"head_size": d // H,
                          "decay_lora_rank": max(32, d // 32)}
    else:
        cfg["derived"] = {"d_inner": 2 * d, "mamba_heads": H,
                          "mamba_head_dim": 2 * d // H,
                          "shared_applications": m["n_layers"]
                          // m["attn_every"]}
    return cfg


def tiny_cell(name: str) -> Dict:
    cell = copy.deepcopy(harness.workload(name))
    tr = cell["traffic"]
    if cell["driver"] == "serve":
        tr.update(clients=4, max_len=64, warmup_steps=6)
        tr["prompt"] = dict(tr["prompt"], lo=8, hi=40)
        tr["output"] = dict(tr["output"], lo=4, hi=12)
        cell["check"]["requests"] = 3
    return cell


def tiny_run(name: str, seed: int = 1234, seconds: float = 1.0,
             trace: bool = False) -> harness.Run:
    import torch
    cell = tiny_cell(name)
    return harness.Run(cell=cell, cfg=tiny_config(cell["config"]), seed=seed,
                       seconds=seconds, trace=trace,
                       device=torch.device("cpu"))
