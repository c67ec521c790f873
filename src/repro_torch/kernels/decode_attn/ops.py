"""GQA decode attention: the Hopper kernel on CUDA tensors, the plain
PyTorch version on CPU tensors.

``decode_attn.launches`` counts the kernel's launches, so a run can show
that its main path went through the kernel, and
``decode_attn.launches_by_route`` the launches of each route
(``kernel.route``: ``tensor_core`` or ``simt``).
"""
from __future__ import annotations

import torch

from ..common import note_cost, shape_only, to_local
from .kernel import ROUTES, decode_attn_cuda
from .ref import decode_attn_ref


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, scale=None) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, S, D); lengths: (B,).  GQA decode."""
    B, H, D = q.shape
    Hkv = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (D ** 0.5))
    if shape_only(q, k, v, lengths):
        return _shape_only(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    out, kind = decode_attn_cuda(q.reshape(B, Hkv, H // Hkv, D), k, v,
                                 lengths.to(torch.int32), scale)
    decode_attn.launches += 1
    decode_attn.launches_by_route[kind] += 1
    note_cost("decode_attn", *decode_attn_cost(B, H, Hkv, k.shape[2], D,
                                               q.element_size()))
    return out.reshape(B, H, D)


def decode_attn_cost(B: int, H: int, Hkv: int, S: int, D: int,
                     itemsize: int):
    """(flops, bytes) when every row attends its whole cache of S: K and V
    read once, q read, the output written; 4 flops per (query head,
    cached element).  The dry run has no lengths, so it counts every row
    at S, the most a call can need."""
    n = B * S
    return (4 * H * n * D,
            (2 * Hkv * n * D + 2 * B * H * D) * itemsize + 4 * B)


def _shape_only(q, k, v, lengths):
    """The dry run's branch (see ``kernels.common``).  On a mesh, each mesh
    dimension that shards the cache's batch or kv-heads axis shards q's
    batch or heads with it; one that shards the cache's sequence axis
    leaves each device a partial softmax over its part of S, which the
    flash-decode combine merges: an all-reduce of the (B, H) float32
    row maxima and one of the output.  Any other placement is replicated
    first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = getattr(k, "device_mesh", None)
    if mesh is not None:
        q_pl, kv_pl, len_pl, out_pl = [], [], [], []
        for p in k.placements:
            if isinstance(p, Shard) and p.dim in (0, 1, 2):
                kv_pl.append(p)
                q_pl.append(p if p.dim < 2 else Replicate())
                len_pl.append(p if p.dim == 0 else Replicate())
                out_pl.append(Partial() if p.dim == 2 else p)
            else:
                q_pl.append(Replicate())
                kv_pl.append(Replicate())
                len_pl.append(Replicate())
                out_pl.append(Replicate())
        ql, kl, vl, ll = (to_local(q, q_pl), to_local(k, kv_pl),
                          to_local(v, kv_pl), to_local(lengths, len_pl))
    else:
        ql, kl = q, k
    B, H, D = ql.shape
    note_cost("decode_attn", *decode_attn_cost(B, H, kl.shape[1],
                                               kl.shape[2], D,
                                               ql.element_size()))
    out = ql.new_empty(ql.shape)
    if mesh is None:
        return out
    out = DTensor.from_local(out, mesh, out_pl, run_check=False,
                             shape=q.shape, stride=q.stride())
    done = [Replicate() if isinstance(p, Partial) else p for p in out_pl]
    if done != out_pl:
        row_max = DTensor.from_local(
            ql.new_empty((B, H), dtype=torch.float32), mesh,
            [Partial("max") if isinstance(p, Partial) else p
             for p in out_pl], run_check=False)
        row_max.redistribute(mesh, done)
        out = out.redistribute(mesh, done)
    return out


decode_attn.launches = 0
decode_attn.launches_by_route = dict.fromkeys(ROUTES, 0)
