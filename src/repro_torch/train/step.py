"""The training step (PyTorch port of ``repro.train.step``): cross-entropy
plus the MoE aux, gradients by autograd (accumulated in float32 over
microbatches), then the AdamW update.

    model = build_model(cfg)                              # on the card
    state = init_train_state(model, torch.Generator(model.device)
                             .manual_seed(0))
    step = make_train_step(model, optim.OptConfig(...))
    state, metrics = step(state, {"inputs": ..., "labels": ...})

Two quirks of the reference are kept as they are: its loss has no
multi-token-prediction term (``repro/train/step.py:52`` is a ``pass``),
and with more than one microbatch ``metrics["ce"]`` holds the whole loss,
MoE aux included, and there is no ``metrics["moe_aux"]``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models.zoo import Model
from . import optimizer as optim

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: nn.Module       # trained in place, gradients on
    opt: optim.OptState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over tokens of logsumexp(logits) minus the gold logit, in
    float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(model: Model, aux_weight: float = 0.01,
                 logits_spec: Optional[Tuple[Any, Any]] = None
                 ) -> Callable[[nn.Module, Batch], Tuple[torch.Tensor, Dict]]:
    """(params, batch) -> (loss, {"ce", "moe_aux" for MoE configs}): the
    cross-entropy of ``model.train_logits`` on ``batch["inputs"]`` against
    ``batch["labels"]``, plus ``aux_weight`` times the MoE aux.  No MTP
    term, as in the reference.  ``logits_spec`` (a DeviceMesh and
    placements) pins DTensor logits' layout before the float32
    cross-entropy, as the reference's sharding constraint does."""
    cfg = model.cfg

    def loss_fn(params: nn.Module, batch: Batch):
        logits, aux = model.train_logits(params, batch["inputs"])
        if logits_spec is not None:
            logits = logits.redistribute(*logits_spec)
        loss = cross_entropy(logits, batch["labels"])
        metrics = {"ce": loss}
        if cfg.moe:
            loss = loss + aux_weight * aux
            metrics["moe_aux"] = aux
        return loss, metrics

    return loss_fn


def _backward(loss_fn, params: nn.Module, batch: Batch):
    """The loss's gradient into every trained parameter's ``.grad`` (zeros
    for a parameter the loss does not reach, as the reference's gradient
    tree has).  Returns (loss, metrics) detached."""
    for p in params.parameters():
        p.grad = None
    loss, metrics = loss_fn(params, batch)
    loss.backward()
    for p in params.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch tensor: rows [i B / n, (i + 1)
    B / n), as the reference splits it.  Of a DTensor (the launch dry
    run), the ``i``-th of ``n`` equal parts of each device's own rows, in
    the batch's placements: every device keeps its share of the work and
    no row moves, and the ``n`` parts together are the batch, as the
    plain split's are (only which rows share a microbatch differs, which
    the accumulated step does not see)."""
    if not hasattr(x, "device_mesh"):
        return x.reshape(n, -1, *x.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    part = local.reshape(n, -1, *local.shape[1:])[i]
    shape = (x.shape[0] // n, *x.shape[1:])
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(part, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def make_train_step(model: Model, opt_cfg: optim.OptConfig,
                    num_microbatches: int = 1,
                    logits_spec: Optional[Tuple[Any, Any]] = None):
    """(state, batch) -> (state, metrics {"ce", "moe_aux"?, "grad_norm",
    "lr", "loss"}).  The batch's leading axis splits into
    ``num_microbatches`` equal parts whose gradients add in float32 and
    are divided by their count, as are their losses.  After the step
    each parameter's ``.grad`` holds the gradient the update applied, in
    the parameter's dtype.  ``logits_spec``: see :func:`make_loss_fn`."""
    loss_fn = make_loss_fn(model, logits_spec=logits_spec)

    def train_step(state: TrainState, batch: Batch):
        params = state.params
        named = dict(params.named_parameters())
        if num_microbatches <= 1:
            loss, metrics = _backward(loss_fn, params, batch)
            grads = {n: p.grad for n, p in named.items()}
        else:
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()}
            total = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(num_microbatches):
                part = {k: microbatch(v, num_microbatches, i)
                        for k, v in batch.items()}
                loss_i, _metrics = _backward(loss_fn, params, part)
                for n, p in named.items():
                    acc[n] = acc[n] + p.grad.float()
                total = total + loss_i
            grads = {n: a / num_microbatches for n, a in acc.items()}
            for n, p in named.items():
                p.grad = grads[n].to(p.dtype)
            loss = total / num_microbatches
            metrics = {"ce": loss}           # the reference's quirk
        _params, opt, opt_metrics = optim.apply(opt_cfg, grads, state.opt,
                                                named)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(params, opt), metrics

    return train_step


def init_train_state(model: Model, gen: torch.Generator) -> TrainState:
    """Parameters from ``model.init(gen)`` with gradients turned on (for
    this module only: every other ``Model.init`` module stays frozen), and
    the optimizer's state for them."""
    params = model.init(gen)
    params.requires_grad_(True)
    return TrainState(params=params,
                      opt=optim.init(dict(params.named_parameters())))
