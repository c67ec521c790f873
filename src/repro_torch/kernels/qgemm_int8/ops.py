"""The int8 quantized GEMM: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``qgemm_int8.launches`` counts the kernel's launches, so a run can show
that its path went through the kernel, and ``qgemm_int8.launches_by_route``
the launches of each route (``kernel.route``: ``tensor_core`` or
``simt``).
"""
from __future__ import annotations

import torch

from ..common import note_cost, replicated_locals, shape_only
from .kernel import ROUTES, qgemm_int8_cuda
from .ref import qgemm_ref


def qgemm_int8(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
               b_scale: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(a_scale[:, None] * b_scale[None, :]) * (a @ b) with the int8
    product accumulated exactly in int32.  a: (M, K), b: (K, N) int8;
    a_scale: (M,), b_scale: (N,) float32.  Any K: past ``kernel.K_MAX``
    the int32 sums wrap as the reference's do, on either device.

    The JAX function's ``bm``/``bn``/``bk`` (TPU block sizes, which its
    wrapper pads to), ``interpret`` and ``use_kernel`` are dropped: the
    Hopper kernel has its own tiles and masks ragged edges, and the
    tensor's device chooses kernel or plain version.  On the card
    ``kernel.route`` chooses the kernel from the shape."""
    if shape_only(a, b, a_scale, b_scale):
        return _shape_only(a, b, a_scale, b_scale, out_dtype)
    if a.device.type == "cpu":
        return qgemm_ref(a, b, a_scale, b_scale, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"qgemm_int8 runs on CPU or CUDA tensors, not "
                         f"{a.device}")
    out, kind = qgemm_int8_cuda(a, b, a_scale, b_scale, out_dtype=out_dtype)
    qgemm_int8.launches += 1
    qgemm_int8.launches_by_route[kind] += 1
    note_cost("qgemm_int8", *qgemm_int8_cost(a.shape[0], a.shape[1],
                                             b.shape[1], out.element_size()))
    return out


def qgemm_int8_cost(M: int, K: int, N: int, out_bytes: int):
    """(operations, bytes): the int8 operands and float32 scales read
    once, the output written once; 2MKN integer operations."""
    return 2 * M * K * N, M * K + K * N + 4 * (M + N) + M * N * out_bytes


def _shape_only(a, b, a_scale, b_scale, out_dtype):
    """The dry run's branch (see ``kernels.common``)."""
    a, b = replicated_locals(a, b)
    out = a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)
    note_cost("qgemm_int8", *qgemm_int8_cost(a.shape[0], a.shape[1],
                                             b.shape[1], out.element_size()))
    return out


qgemm_int8.launches = 0
qgemm_int8.launches_by_route = dict.fromkeys(ROUTES, 0)
