"""Finding a cell's files by name, and assembling its result line.

    BENCHMARK.json                   the cells and metrics
    chipbench/workloads/<cell>.json  config, driver, traffic, check
    chipbench/configs/<config>.json  sizes as run, source, departures
    chipbench/reference/<family>.py  the plain reference
    chipbench/drivers/<driver>.py    how a kind of cell is driven
    chipbench/metrics/<metric>.py    ``read(run) -> float | None``

A later change adds a cell, a configuration or a metric by adding files
and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def reference(cfg: Dict):
    return importlib.import_module(f"chipbench.reference.{cfg['family']}")


def driver(cell: Dict):
    return importlib.import_module(f"chipbench.drivers.{cell['driver']}")


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    those without a ``workloads`` key, and those that list the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` as the file states it: the registry's
    entry with every key of ``model`` set from the file."""
    import torch
    from repro_torch.configs.registry import get_config
    fields = dict(cfg["model"])
    fields["dtype"] = getattr(torch, fields.get("dtype", "bfloat16"))
    base = get_config(cfg["registry_id"])
    known = {f.name for f in dataclasses.fields(base)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"{cfg['name']}: the port's ModelConfig has no "
                         f"{unknown}")
    return dataclasses.replace(base, **fields)


def port_module(cfg: Dict):
    """The class of the port's parameter module (``module:Class``)."""
    mod, _, cls = cfg["port_module"].partition(":")
    return getattr(importlib.import_module(mod), cls)


@dataclass
class Run:
    """What a driver hands the metric readers."""
    cell: Dict
    cfg: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    setup_s: float = math.nan
    window: tuple = (0, 0)            # ns, time.time_ns()
    spans: list = field(default_factory=list)
    requests: list = field(default_factory=list)
    stretch: Any = None               # trace.Stretch of the traced run
    window_peak_bytes: int = 0
    peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Dict] = field(default_factory=dict)
    correct: bool = False

    def device_kind(self) -> str:
        import torch
        if self.device is None or self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self, t: Optional[int]) -> bool:
        return t is not None and self.window[0] <= t <= self.window[1]


def read_metrics(run: Run, entries: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = metric_module(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: Dict[str, Dict]) -> bool:
    """Correct when every number compared is finite and within its
    limit."""
    return bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
