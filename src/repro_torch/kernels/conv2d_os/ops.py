"""The output-stationary direct convolution (valid, stride 1, NHWC): the
Hopper kernel on CUDA tensors, the plain PyTorch version on CPU tensors.

``conv2d_os.launches`` counts the kernel's launches, so a run can show
that its path went through the kernel, and ``conv2d_os.launches_by_route``
the launches of each route (``kernel.route``: ``tensor_core`` or
``simt``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import ROUTES, conv2d_os_cuda
from .ref import conv2d_ref


def conv2d_os(x: torch.Tensor, w: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (N, H, W, Cin), w: (KH, KW, Cin, Cout).  Returns (N, H - KH + 1,
    W - KW + 1, Cout) in ``out_dtype`` (default x's).

    The JAX function's ``bco`` (the TPU's output-channel block, which its
    wrapper pads Cout to), ``interpret`` and ``use_kernel`` are dropped:
    the Hopper kernel has its own tiles and masks a ragged Cout, and the
    tensor's device chooses kernel or plain version.  On the card
    ``kernel.route`` chooses the kernel from the shape."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv2d_ref(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_os runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    out, r = conv2d_os_cuda(x, w, out_dtype=out_dtype)
    conv2d_os.launches += 1
    conv2d_os.launches_by_route[r.kind] += 1
    return out


conv2d_os.launches = 0
conv2d_os.launches_by_route = dict.fromkeys(ROUTES, 0)
