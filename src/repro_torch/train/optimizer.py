"""AdamW with float32 master weights and moments, global-norm clipping and
a warmup + cosine schedule (PyTorch port of ``repro.train.optimizer``).

The state holds dictionaries of named tensors, the names those of the
trained module's ``named_parameters()``.  The update runs in place under
``torch.no_grad()`` (the reference's arrays are immutable and its update
returns new ones; the values are the same): each float32 master weight
takes ``w - lr * (m_hat / (sqrt(v_hat) + eps) + wd * w)`` in the
reference's order, and the parameter becomes the master cast to its own
dtype.  ``torch.optim.AdamW`` is not used: its decay is applied as a
separate multiply before the step, not inside ``lr * (step + wd * w)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int
    master: Tensors     # float32 copy of the params
    m: Tensors
    v: Tensors


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: OptConfig, step: int) -> torch.Tensor:
    """The learning rate at ``step``, a float32 scalar (on the CPU),
    computed in float32 as the reference computes it: linear warmup, then
    a cosine from ``lr`` down to ``min_lr_frac * lr`` at ``total_steps``,
    the smaller of the two."""
    s = _f32(step)
    warm = cfg.lr * (s + 1) / max(1, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.minimum(warm, cfg.lr * cos)


def init(params: Tensors) -> OptState:
    """Step 0, float32 copies of the params, zero moments."""
    return OptState(
        step=0,
        master={n: p.detach().to(torch.float32, copy=True)
                for n, p in params.items()},
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()})


@torch.no_grad()
def apply(cfg: OptConfig, grads: Tensors, state: OptState, params: Tensors
          ) -> Tuple[Tensors, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step from ``grads`` (any float dtype, every name of
    ``params``).  Updates the master weights, the moments and ``params``
    in place and returns (params, the state at the next step, {"grad_norm",
    "lr"}, float32 scalars).

    The global norm sums each leaf's float32 squares; the clip scale is
    ``min(1, clip_norm / (gnorm + 1e-9))``; the bias corrections are
    ``1 - b^t`` in float32 with t the new step count."""
    names = list(params)
    dev = next(iter(params.values())).device
    gsq = torch.zeros((), dtype=torch.float32, device=dev)
    for n in names:
        gsq = gsq + grads[n].float().square().sum()
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = float(schedule(cfg, state.step))
    t = state.step + 1
    bc1 = float(1 - _f32(cfg.b1) ** _f32(t))
    bc2 = float(1 - _f32(cfg.b2) ** _f32(t))
    b1, b2 = cfg.b1, cfg.b2
    for n in names:
        g = grads[n].float() * scale
        m, v, w = state.m[n], state.v[n], state.master[n]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        w.sub_(lr * (step + cfg.weight_decay * w))
        params[n].copy_(w.to(params[n].dtype))
    new_state = OptState(step=t, master=state.master, m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm,
                               "lr": torch.tensor(lr, dtype=torch.float32)}
