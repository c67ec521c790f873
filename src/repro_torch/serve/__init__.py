"""CGRA-backed model serving (PyTorch port of ``repro.serve``): engine +
offload plans + traffic harness.

``plan``/``traffic`` import lazily — ``engine`` alone must stay importable
without pulling the whole toolchain."""
from .engine import Engine, Request

__all__ = ["Engine", "Request", "ServePlan", "build_serve_plan",
           "CGRAExecutionModel", "TrafficConfig", "FixedLatencyModel",
           "run_traffic"]


def __getattr__(name):
    if name in ("ServePlan", "PlanSite", "build_serve_plan",
                "CGRAExecutionModel"):
        from . import plan
        return getattr(plan, name)
    if name in ("TrafficConfig", "FixedLatencyModel", "run_traffic",
                "generate_requests", "report_json", "report_bench_rows"):
        from . import traffic
        return getattr(traffic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
