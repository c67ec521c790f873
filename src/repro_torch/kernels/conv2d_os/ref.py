"""Plain PyTorch version of the output-stationary direct convolution.

``conv2d_tf32x3`` emulates the arithmetic of the float32 ``tf32x3`` route
for the tests, as ``gemm_os.ref.matmul_tf32x3`` does the GEMM's; no
wrapper calls it."""
from __future__ import annotations

import torch

from ..gemm_os.ref import matmul_tf32x3


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


def conv2d_tf32x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The valid, stride-1 NHWC convolution as the tf32x3 route sums it:
    per tap, the implicit GEMM (N OH OW, Cin) @ (Cin, Cout) by
    ``matmul_tf32x3`` (three TF32 products per 8 channels), the taps'
    float32 sums added in order.  Returns (N, OH, OW, Cout) in float32."""
    N, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    OH, OW = H - KH + 1, W - KW + 1
    acc = torch.zeros((N * OH * OW, Cout), dtype=torch.float32,
                      device=x.device)
    for kh in range(KH):
        for kw in range(KW):
            patch = x[:, kh:kh + OH, kw:kw + OW, :].reshape(-1, Cin)
            acc = acc + matmul_tf32x3(patch, w[kh, kw])
    return acc.reshape(N, OH, OW, Cout)
