"""Spans of the serving path on the host's clock, off unless turned on.

    from repro_torch import spans
    spans.enable()
    ...                            # Engine.admit / Engine.step
    spans.disable()
    recorded = spans.take()        # the spans, in order of their start

Each span site in the engine and the models reads::

    with spans.span("model.decode") if spans.ON else spans.OFF:
        ...

so a site costs one flag test while spans are off.  Stamps come from
``time.time_ns()``, the clock ``torch.profiler`` stamps its host and
device events in, so a kernel or an idle gap of the card can be put
inside the innermost span that was open on the host at that moment.

Spans nest by the call stack of one thread: ``parent`` is the index, in
the list ``take()`` returns, of the span that was innermost when this one
opened.  The recorder is one per process; take the spans between calls,
not inside one.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ON = False                      # tested at every site before a span is built
OFF = contextlib.nullcontext()  # the site's context while spans are off


@dataclass
class Span:
    name: str
    t0: int                     # ns, time.time_ns()
    t1: int = 0                 # 0 while open
    parent: Optional[int] = None
    meta: Dict = field(default_factory=dict)


_spans: List[Span] = []
_open: List[int] = []           # indices into _spans, innermost last


class span:
    """``with span(name, **meta):`` records ``name`` around the block."""

    __slots__ = ("name", "meta", "span", "depth")

    def __init__(self, name: str, **meta):
        self.name = name
        self.meta = meta

    def __enter__(self) -> Span:
        self.depth = len(_open)
        self.span = Span(name=self.name, t0=time.time_ns(),
                         parent=_open[-1] if _open else None, meta=self.meta)
        _open.append(len(_spans))
        _spans.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.t1 = time.time_ns()
        del _open[self.depth:]
        return False


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def take() -> List[Span]:
    """The spans recorded since the last ``take()``, which are cleared."""
    global _spans
    out, _spans = _spans, []
    _open.clear()
    return out
