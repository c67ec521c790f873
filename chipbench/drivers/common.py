"""What both drivers do: build the port's model on the benchmark's
weights, keep time, and read the device's memory."""
from __future__ import annotations

import gc
from typing import Dict

import torch

from chipbench import harness, weights


def build(run: harness.Run):
    """(ModelConfig, Model, params module) of the cell's configuration,
    the parameters drawn from the seed by the reference's specification."""
    from repro_torch.models.zoo import build_model
    mcfg = harness.model_config(run.cfg)
    model = build_model(mcfg, run.device)
    params = harness.port_module(run.cfg)(mcfg, None, device="meta")
    specs = harness.reference(run.cfg).param_specs(run.cfg)
    weights.install(params, weights.draw(specs, run.seed, run.device))
    return mcfg, model, params


def reference_weights(run: harness.Run) -> Dict[str, torch.Tensor]:
    """The same weights again, as drawn, in the dtype they are served in;
    the reference upcasts each where it uses it."""
    specs = harness.reference(run.cfg).param_specs(run.cfg)
    return weights.draw(specs, run.seed, run.device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
