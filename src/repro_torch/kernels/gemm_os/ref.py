"""Plain PyTorch version of the output-stationary GEMM:
``C = act(A @ B + bias)``, computed in float32."""
from __future__ import annotations

from typing import Optional

import torch

ACTIVATIONS = (None, "relu", "gelu", "silu")


def gemm_ref(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             out_dtype=None) -> torch.Tensor:
    """a: (M, K), b: (K, N), bias: (N,) or None; activation one of
    ACTIVATIONS (gelu in its tanh form).  Returns (M, N) in ``out_dtype``
    (default a's)."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()[None, :]
    if activation == "relu":
        acc = torch.clamp_min(acc, 0.0)
    elif activation == "gelu":
        acc = 0.5 * acc * (1.0 + torch.tanh(
            0.7978845608028654 * (acc + 0.044715 * acc ** 3)))
    elif activation == "silu":
        acc = acc * (1.0 / (1.0 + torch.exp(-acc)))
    elif activation is not None:
        raise ValueError(activation)
    return acc.to(out_dtype)
