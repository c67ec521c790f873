"""The output-stationary GEMM ``act(A @ B + bias)``: the Hopper kernel on
CUDA tensors, the plain PyTorch version on CPU tensors.

``gemm_os.launches`` counts the kernel's launches, so a run can show that
its path went through the kernel, and ``gemm_os.launches_by_route`` the
launches of each route (``kernel.route``: ``tensor_core`` or ``simt``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import ROUTES, gemm_os_cuda
from .ref import gemm_ref


def gemm_os(a: torch.Tensor, b: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            activation: Optional[str] = None, coalesce_grid: bool = False,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """act(A @ B + bias) for any M, K, N.  a: (M, K), b: (K, N), bias:
    (N,) or None; activation None, "relu", "gelu" (tanh form) or "silu";
    ``coalesce_grid`` launches one flat loop over the output tiles
    (Listing 4) and gives the same result bit for bit.

    The JAX function's ``bm``/``bn``/``bk`` (TPU block sizes, which its
    wrapper pads to), ``interpret`` (Pallas' CPU mode) and ``use_kernel``
    are dropped: the Hopper kernel has its own tiles and masks ragged
    edges, and the tensor's device chooses kernel or plain version.  On
    the card ``kernel.route`` chooses the kernel from the shape."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_ref(a, b, bias, activation, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_os runs on CPU or CUDA tensors, not "
                         f"{a.device}")
    out, r = gemm_os_cuda(a, b, bias, activation=activation,
                          coalesce_grid=coalesce_grid, out_dtype=out_dtype)
    gemm_os.launches += 1
    gemm_os.launches_by_route[r.kind] += 1
    return out


gemm_os.launches = 0
gemm_os.launches_by_route = dict.fromkeys(ROUTES, 0)
