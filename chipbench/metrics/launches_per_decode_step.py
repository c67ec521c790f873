"""Kernels the host launched inside the decode-step spans of the traced
stretch, over those steps."""
from chipbench.readers import stretch_spans


def read(run):
    if run.stretch is None:
        return None
    spans = stretch_spans(run, "decode_step")
    ids = {id(s) for s in spans}
    n = sum(1 for k in run.stretch.ops if k.kernel and id(k.span) in ids)
    return n / len(spans) if spans and n else None
