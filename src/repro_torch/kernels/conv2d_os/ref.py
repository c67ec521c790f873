"""Plain PyTorch version of the output-stationary direct convolution."""
from __future__ import annotations

import torch


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Valid, stride-1 NHWC convolution in float32.  x: (N, H, W, Cin),
    w: (KH, KW, Cin, Cout).  Returns (N, OH, OW, Cout) in ``out_dtype``
    (default x's)."""
    out_dtype = out_dtype or x.dtype
    N, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    OH, OW = H - KH + 1, W - KW + 1
    acc = torch.zeros((N, OH, OW, Cout), dtype=torch.float32,
                      device=x.device)
    for kh in range(KH):
        for kw in range(KW):
            patch = x[:, kh:kh + OH, kw:kw + OW, :].float()
            acc = acc + torch.einsum("nhwc,co->nhwo", patch,
                                     w[kh, kw].float())
    return acc.to(out_dtype)
