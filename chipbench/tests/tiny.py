"""Tiny CPU versions of the benchmark's configurations and cells, for the
tests: the port's ``ModelConfig.reduced()`` sizes in float32."""
from __future__ import annotations

import copy
from typing import Dict

from chipbench import harness


def tiny_config(name: str) -> Dict:
    """The configuration at the port's ``reduced()`` sizes in float32,
    with the rest as its family's reference sets it (``tiny``)."""
    cfg = copy.deepcopy(harness.config(name))
    small = harness.model_config(cfg).reduced()
    m = cfg["model"]
    for key in list(m):
        value = getattr(small, key)
        m[key] = "float32" if key == "dtype" else value
    return harness.reference(cfg).tiny(cfg)


def tiny_cell(name: str) -> Dict:
    """The cell with its traffic at the size its driver sets
    (``tiny_traffic``)."""
    cell = copy.deepcopy(harness.workload(name))
    return harness.driver(cell).tiny_traffic(cell)


def tiny_run(name: str, seed: int = 1234, seconds: float = 1.0,
             trace: bool = False) -> harness.Run:
    import torch
    cell = tiny_cell(name)
    return harness.Run(cell=cell, cfg=tiny_config(cell["config"]), seed=seed,
                       seconds=seconds, trace=trace,
                       device=torch.device("cpu"))
