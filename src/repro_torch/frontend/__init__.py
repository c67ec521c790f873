"""repro_torch.frontend — the traced, Pallas-style kernel DSL.

The compile entry point's authoring layer (paper Fig. 3 piece 3/4): kernel
bodies are restricted Python over a :class:`KernelContext`, lowered by the
tracer to the DFG + data-layout + invocation-schedule triple that
``Toolchain.compile`` consumes:

    from repro_torch.frontend import KernelContext, trace
    from repro_torch.core import Toolchain

    ctx = KernelContext("triple", layout)
    X, Y = ctx.arrays("X", "Y")
    n = ctx.counter(stop=N - 1)
    Y[n] = X[n] * 3
    dfg = ctx.build()

Higher-level pieces:

  * :mod:`repro_torch.frontend.tracer` — the tracer (``TracedValue``,
    ``ArrayRef``, counter/coalesce primitives, ``unroll``).
  * :mod:`repro_torch.frontend.library` — DSL-only kernels beyond Table I
    (depthwise conv, average pooling, bias+ReLU GEMM epilogue, int8
    requantize) plus :class:`KernelProgram`, the arch-deferred form
    ``Toolchain.compile`` accepts directly.

Attributes resolve lazily (PEP 562, same idiom as ``repro_torch.core``) so that
``repro_torch.core.kernels_lib`` can import the tracer without dragging the
kernel library (which itself imports ``kernels_lib``) into the cycle.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "KernelContext": ".tracer",
    "TracedValue": ".tracer",
    "ArrayRef": ".tracer",
    "TraceError": ".tracer",
    "trace": ".tracer",
    "unroll": ".tracer",
    "KernelProgram": ".library",
    "build_dwconv": ".library",
    "build_avgpool2x2": ".library",
    "build_gemm_bias_relu": ".library",
    "build_requant_int8": ".library",
    "dsl_kernels": ".library",
    "DSL_PROGRAMS": ".library",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(modname, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
