"""Mean host ms of an ``Engine.step`` in the window: the benchmark's span
around each step, summed, over the number of steps."""
from chipbench.readers import window_spans


def read(run):
    steps = window_spans(run, "decode_step")
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / 1e6 / len(steps)
