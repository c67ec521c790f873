"""The program's own spans (``repro_torch.spans``) against the benchmark's
spans and the traced stretch: host time inside a span of the program, and
the card's idle time put down to the innermost span of the program that
was open on the host (``run.program_spans``).

The host's own times come from a traced run's window, which runs the
program's spans with no profiler (``run.window_program_spans``); the
card's idle time, from the profiled stretch.

Kept apart from ``trace.reduce`` and ``trace.idle_by_host_span``: those
bisect over the starts of the benchmark's spans, which never nest; the
program's do.  Every reader returns None where a run holds no program
spans, as a run of a program without them does.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from chipbench.readers import stretch_spans, window_spans

OUTSIDE = "outside spans"     # trace.idle_by_host_span's name for the rest

Piece = Tuple[int, int, Optional[str]]     # ns, ns, label


def program_spans(run) -> list:
    return getattr(run, "program_spans", None) or []


def innermost(spans: Sequence) -> List[Tuple[int, int, int]]:
    """The host's timeline inside closed program spans, as ordered,
    disjoint (start, end, index of the innermost open span) pieces."""
    closed = [s.t1 > 0 for s in spans]
    children, roots = defaultdict(list), []
    for i, s in enumerate(spans):
        if not closed[i]:
            continue
        p = s.parent
        (children[p] if p is not None and closed[p] else roots).append(i)
    out: List[Tuple[int, int, int]] = []

    def walk(i: int) -> None:
        at = spans[i].t0
        for c in children[i]:
            if spans[c].t0 > at:
                out.append((at, spans[c].t0, i))
            walk(c)
            at = max(at, spans[c].t1)
        if spans[i].t1 > at:
            out.append((at, spans[i].t1, i))

    for r in roots:
        walk(r)
    return out


def split(xs: Sequence[Piece], ys: Sequence[Piece]
          ) -> List[Tuple[int, int, Optional[str], Optional[str]]]:
    """Each piece of ``xs`` cut where the pieces of ``ys`` begin and end:
    (start, end, x's label, the label of the y piece over it or None).
    Both ordered and disjoint; the output covers ``xs`` exactly."""
    out = []

    def put(a, b, lx, ly):
        if b > a:
            out.append((a, b, lx, ly))

    j = 0
    for a, b, lx in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        at, k = a, j
        while k < len(ys) and ys[k][0] < b:
            y0, y1, ly = ys[k]
            put(at, y0, lx, None)
            put(max(at, y0), min(b, y1), lx, ly)
            at = max(at, min(b, y1))
            if y1 > b:
                break
            k += 1
        put(at, b, lx, None)
    return out


def idle_pieces(stretch) -> List[Piece]:
    """The stretch's intervals in which no operation ran on the card."""
    edges = [stretch.t0] + [x for iv in stretch.busy_intervals()
                            for x in iv] + [stretch.t1]
    return [(a, b, None) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def _named(spans: Sequence, name: str, within: Sequence) -> List[Piece]:
    """Closed program spans of ``name`` lying wholly inside one of the
    benchmark's spans ``within``, as pieces."""
    starts = [s.t0 for s in within]
    out = []
    for s in spans:
        if s.name != name or not s.t1:
            continue
        i = bisect.bisect_right(starts, s.t0) - 1
        if i >= 0 and s.t1 <= within[i].t1:
            out.append((s.t0, s.t1, name))
    return out


def idle_gaps_program(run, n: int = 10) -> Optional[List[list]]:
    """Idle seconds of the card in the stretch, named ``<benchmark
    span>/<innermost program span>``, or ``<benchmark span>`` where no
    program span was open; the ``n`` largest (all for None)."""
    st, prog = run.stretch, program_spans(run)
    if st is None or not prog:
        return None
    bench = [(s.t0, s.t1, s.name) for s in run.spans if s.t1]
    inner = [(a, b, prog[i].name) for a, b, i in innermost(prog)]
    by: Dict[str, float] = {}
    named = [(a, b, lb or OUTSIDE)
             for a, b, _, lb in split(idle_pieces(st), bench)]
    for a, b, lb, lp in split(named, inner):
        key = f"{lb}/{lp}" if lp else lb
        by[key] = by.get(key, 0.0) + (b - a) / 1e9
    top = sorted(by.items(), key=lambda kv: -kv[1])
    return [[k, v] for k, v in (top if n is None else top[:n])]


def host_ms_per_step(run, name: str) -> Optional[float]:
    """Mean host ms a decode step inside program spans of ``name``, over
    the benchmark's decode steps of the window, which ran the program's
    spans without the profiler: under the profiler a replayed graph's
    launch takes milliseconds, not tens of microseconds."""
    steps = window_spans(run, "decode_step")
    prog = getattr(run, "window_program_spans", None) or []
    if not steps or not prog:
        return None
    inside = _named(prog, name, steps)
    return sum(b - a for a, b, _ in inside) / 1e6 / len(steps)


def idle_ns_inside(run, name: str, within: Sequence) -> int:
    """Idle ns of the card while the host was inside program spans of
    ``name`` (their children included) that lie in ``within``."""
    inside = _named(program_spans(run), name, within)
    return sum(b - a for a, b, _, lp in split(idle_pieces(run.stretch),
                                               inside) if lp)


def decode_launch_ms(run) -> Optional[float]:
    return host_ms_per_step(run, "model.decode")


def decode_readback_ms(run) -> Optional[float]:
    return host_ms_per_step(run, "engine.step.readback")


def prefill_launch_idle_ms_per_ktok(run) -> Optional[float]:
    pre = stretch_spans(run, "prefill")
    tokens = sum(s.meta["tokens"] for s in pre)
    if not tokens or not program_spans(run):
        return None
    return idle_ns_inside(run, "model.prefill", pre) / 1e6 / tokens * 1000
