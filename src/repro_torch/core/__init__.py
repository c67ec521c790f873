"""Morpher reproduction core: the integrated CGRA flow (paper Fig. 3).

The whole compile pipeline is re-exported here so callers can write

    from repro_torch.core import Toolchain, MapperOptions, build_gemm

    ck = Toolchain().compile(build_gemm(TI=6, TK=8, TJ=6))
    ck.verify()

Attributes resolve lazily (PEP 562) so importing ``repro_torch.core`` does not
pull in torch until the simulator or the DFG oracle is actually used.  The
map lists only the modules this package ports.
"""
from __future__ import annotations

import importlib

# public name -> submodule providing it
_FLOW = {
    # staged toolchain (the canonical API)
    "Toolchain": ".toolchain",
    "CompiledKernel": ".toolchain",
    "default_toolchain": ".toolchain",
    "default_cache_dir": ".toolchain",
    "spec_cache_key": ".toolchain",
    # mapper
    "MapperOptions": ".mapper",
    "Mapping": ".mapper",
    "MapError": ".mapper",
    "map_kernel": ".mapper",          # deprecated shim
    "map_kernel_opts": ".mapper",
    "compute_mii": ".mapper",
    # architecture description
    "CGRAArch": ".adl",
    "cluster_4x4": ".adl",
    "morpher_8x8": ".adl",
    # kernels / IR / layout
    "KernelSpec": ".kernels_lib",
    "build_gemm": ".kernels_lib",
    "build_conv": ".kernels_lib",
    "table1_kernels": ".kernels_lib",
    "DFG": ".dfg",
    "DFGBuilder": ".dfg",
    "DataLayout": ".layout",
    "assign_layout": ".layout",
    # configuration + simulation + verification
    "SimConfig": ".config_gen",
    "generate_config": ".config_gen",
    "narrowed_planes": ".config_gen",
    "simulate": ".simulator",
    "simulate_batch": ".simulator",
    "generate_test_data": ".verify",
    "generate_test_data_batch": ".verify",
    "check_dfg_semantics": ".verify",
    # cost model
    "kernel_cost": ".costmodel",
    "KernelCost": ".costmodel",
}

__all__ = sorted(_FLOW)


def __getattr__(name: str):
    try:
        modname = _FLOW[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(modname, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_FLOW))
