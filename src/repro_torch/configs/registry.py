"""Architecture registry: --arch <id> resolves here.

Each config file defines CONFIG with the reference's values; the registry
maps ids -> ModelConfig for all ten, which ``repro_torch.models.zoo.
build_model`` builds, the GEMM-site analyzer (``repro_torch.core.offload``)
analyzes and serve plans plan.  Input-shape cells (seq_len x global_batch),
which the launch dry run and the roofline run, are defined here too.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.common import ModelConfig

ARCH_IDS = [
    "rwkv6-1.6b",
    "llama3.2-1b",
    "llama3.2-3b",
    "granite-34b",
    "codeqwen1.5-7b",
    "zamba2-1.2b",
    "musicgen-large",
    "llava-next-mistral-7b",
    "llama4-maverick-400b-a17b",
    "deepseek-v3-671b",
]

_MODULE = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE[arch_id]}")
    return mod.CONFIG


def serve_smoke_config(arch_id: str) -> ModelConfig:
    """Shrunken same-family config for serve smoke runs and tests: the
    reduced() CPU config, renamed so it can't be mistaken for the full
    model."""
    cfg = get_config(arch_id).reduced()
    return dataclasses.replace(cfg, name=f"{cfg.name}-serve-smoke")


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (O(1)-state recurrence):
    skip for full-attention archs, run for SSM/hybrid."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: full quadratic attention cannot decode at "
                       "524288 context; arch defines no sub-quadratic path")
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
