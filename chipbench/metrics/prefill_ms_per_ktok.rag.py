"""Host ms of ``Engine.admit`` per thousand prompt tokens in the window:
the spans around each admission, summed, over the tokens admitted."""
from chipbench.readers import window_spans


def read(run):
    spans = window_spans(run, "prefill")
    tokens = sum(s.meta["tokens"] for s in spans)
    if not tokens:
        return None
    return sum(s.t1 - s.t0 for s in spans) / 1e6 / tokens * 1000
