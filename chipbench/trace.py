"""Spans on the host's clock, and the device trace of a bounded stretch.

Spans are the benchmark's own, around each call into the program
(``Engine.admit``, ``Engine.step``, the training step), timed by
``time.time_ns()``: the clock the profiler's events are stamped in, so a
kernel is attributed to the span in which the host launched it.  The
stretch records CUDA activity only (kernels, copies, the runtime calls
that launched them), which adds no per-operator cost on the host.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset", "cudaMemcpy2DAsync")


@dataclass
class Span:
    name: str
    t0: int                   # ns, time.time_ns()
    t1: int = 0
    meta: Dict = field(default_factory=dict)


class Recorder:
    """Spans in order of their start."""

    def __init__(self):
        self.spans: List[Span] = []

    def open(self, name: str, **meta) -> Span:
        s = Span(name, time.time_ns(), 0, meta)
        self.spans.append(s)
        return s

    @staticmethod
    def close(span: Span) -> None:
        span.t1 = time.time_ns()


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments or parameters: ``void ns::k<64>(float*)`` -> ``k``."""
    name = name.strip().replace("(anonymous namespace)", "anon")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):          # the first '(' outside <...>
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = name[:cut].rstrip()
    while head.endswith(">"):              # the function's template args
        depth, j = 0, len(head) - 1
        while j >= 0:
            depth += {">": 1, "<": -1}.get(head[j], 0)
            if depth == 0:
                break
            j -= 1
        head = head[:j].rstrip()
    head = re.split(r"\s", head)[-1]
    return head.rsplit("::", 1)[-1]


@dataclass
class DeviceOp:
    name: str                 # base name
    t0: int                   # ns on the host's clock
    t1: int
    kernel: bool              # False for copies and memsets
    launched: Optional[int]   # ns when the host launched it, if known
    span: Optional[Span] = None


@dataclass
class Stretch:
    t0: int
    t1: int
    ops: List[DeviceOp]
    matched: int              # ops whose launch was found

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations, clipped to the stretch."""
        iv = sorted((max(o.t0, self.t0), min(o.t1, self.t1))
                    for o in self.ops)
        out: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels_in(self, span_name: str, prefixes=(),
                   exclude=()) -> List[DeviceOp]:
        """Kernels launched inside spans of ``span_name`` whose base name
        starts with one of ``prefixes`` (all if empty) and with none of
        ``exclude``."""
        out = []
        for o in self.ops:
            if not o.kernel or o.span is None or o.span.name != span_name:
                continue
            if prefixes and not o.name.startswith(tuple(prefixes)):
                continue
            if exclude and o.name.startswith(tuple(exclude)):
                continue
            out.append(o)
        return out


class Profiler:
    """``with Profiler(recorder) as p: ...`` traces CUDA activity; then
    ``p.stretch`` holds the reduction."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder
        self.stretch: Optional[Stretch] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.stretch = reduce(self._prof, self._t0, t1,
                                  self.recorder.spans)
        return False


def reduce(prof, t0: int, t1: int, spans: List[Span]) -> Stretch:
    """Device operations of the trace with their launch time and the span
    that launched them."""
    from torch.autograd import DeviceType
    launches: Dict[int, int] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in LAUNCHES:
                for c in (e.correlation_id(), e.linked_correlation_id()):
                    if c:
                        launches[c] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA:
            device.append(e)
    starts = [s.t0 for s in spans]
    ops, matched = [], 0
    for e in device:
        name = e.name()
        kernel = not (name.startswith("Memcpy") or name.startswith("Memset")
                      or name.startswith("[memory]"))
        hit = None
        for c in (e.correlation_id(), e.linked_correlation_id()):
            if c and c in launches:
                hit = launches[c]
                break
        op = DeviceOp(base_name(name) if kernel else name.split(" ")[0],
                      e.start_ns(), e.start_ns() + e.duration_ns(), kernel,
                      hit)
        if hit is not None:
            matched += 1
            i = bisect.bisect_right(starts, op.launched) - 1
            if i >= 0 and spans[i].t0 <= op.launched <= (spans[i].t1 or t1):
                op.span = spans[i]
        ops.append(op)
    return Stretch(t0, t1, ops, matched)


def top_device_ops(stretch: Stretch, n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for o in stretch.ops:
        by[o.name] = by.get(o.name, 0.0) + (o.t1 - o.t0) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host_span(stretch: Stretch, spans: List[Span],
                      n: int = 10) -> List[list]:
    """Idle device time in the stretch, split by the span the host was in
    (``outside spans`` between them)."""
    busy = stretch.busy_intervals()
    edges = [stretch.t0] + [x for iv in busy for x in iv] + [stretch.t1]
    done = [s for s in spans if s.t1]
    ends = [s.t1 for s in done]
    by: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inside = 0
        i = bisect.bisect_right(ends, a)
        while i < len(done) and done[i].t0 < b:
            part = min(b, done[i].t1) - max(a, done[i].t0)
            if part > 0:
                by[done[i].name] = by.get(done[i].name, 0.0) + part / 1e9
                inside += part
            i += 1
        if b - a > inside:
            by["outside spans"] = by.get("outside spans", 0.0) \
                + (b - a - inside) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
