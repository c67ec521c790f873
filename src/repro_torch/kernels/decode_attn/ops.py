"""GQA decode attention: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``decode_attn.launches`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .kernel import decode_attn_cuda
from .ref import decode_attn_ref


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, scale=None) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, S, D); lengths: (B,).  GQA decode."""
    B, H, D = q.shape
    Hkv = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (D ** 0.5))
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    out = decode_attn_cuda(q.reshape(B, Hkv, H // Hkv, D), k, v,
                           lengths.to(torch.int32), scale)
    decode_attn.launches += 1
    return out.reshape(B, H, D)


decode_attn.launches = 0
