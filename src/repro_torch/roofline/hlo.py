"""Cost and collective-byte accounting of a traced program (PyTorch
counterpart of ``repro.roofline.hlo``).

The reference reads XLA's compiled HLO: ``cost_analysis`` for flops and
bytes, and the HLO text for collectives.  An eager program has no HLO, so
the port counts the program as it is traced: :class:`TraceCounter` is a
dispatch mode that sees every op on *local* tensors -- it lets DTensor
desugar each op into its local computation and collectives first -- so
every count is per device, as the reference's ``cost_analysis`` is (SPMD
programs are per device).

  * flops: ``torch.utils.flop_counter``'s formulas on the local shapes,
    plus each kernel's own formula where a kernel wrapper takes its
    shape-only branch (``repro_torch.kernels.common.note_cost``);
  * bytes accessed: each op's floating-point inputs read once and outputs
    written once (views and allocations move nothing; integer-only index
    bookkeeping is not counted).  XLA fuses elementwise chains and counts
    a fusion's bytes once, so this is an upper bound of what the
    reference's figure measures;
  * transcendentals: output elements of exp / log / tanh / sigmoid /
    rsqrt / sqrt / sin / cos / erf / pow / silu;
  * collectives: output bytes of each ``_c10d_functional`` collective,
    summed per kind under the reference's names.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import common as kcommon
from ..launch import rules

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "silu", "_softmax", "_log_softmax", "logsumexp"}

_NO_TRAFFIC = {"view", "_unsafe_view", "reshape", "expand", "permute",
               "transpose", "t", "unsqueeze", "squeeze", "select", "slice",
               "split", "split_with_sizes", "chunk", "unbind", "as_strided",
               "alias", "detach", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided", "lift_fresh",
               "diagonal", "narrow", "view_as_real", "view_as_complex",
               "unfold", "expand_as", "view_as", "wait_tensor", "device",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "is_contiguous"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts flops, bytes accessed, transcendentals and collective bytes
    of everything run inside it, per device (see the module note)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.collectives: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.kernels: Dict[str, int] = {}

    def _kernel(self, name: str, flops: float, nbytes: float,
                transcendentals: float) -> None:
        n = kcommon.repeat_factor()
        self.flops += n * flops
        self.bytes_accessed += n * nbytes
        self.transcendentals += n * transcendentals
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __enter__(self):
        kcommon.COST_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kcommon.COST_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            rules.install()     # DTensor's own shape work stays unseen
            return NotImplemented      # DTensor: desugar to local ops first
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        packet = func.overloadpacket
        name = packet.__name__
        n = kcommon.repeat_factor()
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives[kind] += n * sum(_bytes(t)
                                                  for t in _tensors(out))
            return out
        if packet in flop_registry:
            self.flops += n * flop_registry[packet](
                *args, **kwargs, out_val=out)
        if name.rstrip("_") in _NO_TRAFFIC:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.is_floating_point() for t in ins + outs):
            return out
        self.bytes_accessed += n * sum(_bytes(t) for t in ins + outs)
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += n * sum(t.numel() for t in outs)
        return out


def collective_bytes(trace: TraceCounter) -> Dict[str, int]:
    """Output bytes summed per collective kind (per device), with every
    kind present and their ``total``."""
    out = {k: int(trace.collectives.get(k, 0)) for k in KINDS}
    out["total"] = sum(out.values())
    return out


def cost_terms(trace: TraceCounter) -> Dict[str, float]:
    """The reference's ``cost_analysis`` terms, per device."""
    return {"flops": float(trace.flops),
            "bytes_accessed": float(trace.bytes_accessed),
            "transcendentals": float(trace.transcendentals)}
