"""Architecture registry: --arch <id> resolves here.

Each config file defines CONFIG with the reference's values; the registry
maps ids -> ModelConfig for all ten.  Families the port does not build yet
(hybrid, MoE / MLA / MTP, embedding inputs) are refused by
``repro_torch.models.zoo.build_model``, not here: their configs still feed
the GEMM-site analyzer (``repro_torch.core.offload``) and serve plans.
"""
from __future__ import annotations

import dataclasses
import importlib

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
