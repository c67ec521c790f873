"""What the metric readers share: the tail of a list, spans inside the
window or the stretch, a roofline share, and the model's flops."""
from __future__ import annotations

import statistics
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from chipbench.peaks import flops_peak, peaks


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default), or None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def window_spans(run, name: str) -> List:
    """Spans of ``name`` that ended inside the window."""
    return [s for s in run.spans if s.name == name and run.in_window(s.t1)]


def stretch_spans(run, name: str) -> List:
    """Spans of ``name`` wholly inside the traced stretch."""
    st = run.stretch
    if st is None:
        return []
    return [s for s in run.spans if s.name == name
            and s.t0 >= st.t0 and s.t1 and s.t1 <= st.t1]


def ttfts_ms(run) -> List[float]:
    return [(s.t_first - s.t_sent) / 1e6 for s in run.requests
            if run.in_window(s.t_first)]


def roofline(run, span_name: str, prefixes: Iterable[str],
             work: Callable[[dict, dict], Tuple[float, float]],
             dtype: str, exclude: Iterable[str] = ()) -> Optional[float]:
    """The share (%) of the bound in the device time of the kernels named
    by ``prefixes`` (less ``exclude``) that the host launched inside the
    stretch's spans of ``span_name``.  ``work(cfg, span.meta)`` gives
    (flops, bytes) of the op's calls in one span; the bound is the larger
    of flops at the fastest rate for ``dtype`` inputs and bytes at the
    memory's rate.  None when no such kernel ran."""
    st = run.stretch
    if st is None:
        return None
    spans = stretch_spans(run, span_name)
    ids = {id(s) for s in spans}
    ks = [k for k in st.kernels_in(span_name, prefixes, exclude)
          if id(k.span) in ids]
    seconds = sum(k.t1 - k.t0 for k in ks) / 1e9
    if not ks or seconds <= 0:
        return None
    flops = nbytes = 0.0
    for s in spans:
        f, b = work(run.cfg, s.meta)
        flops += f
        nbytes += b
    p = peaks(run.device_kind())
    bound = max(flops / flops_peak(p, dtype), nbytes / p["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def token_flops(cfg: dict, tokens: int, context_sum: int) -> float:
    """The model's forward flops for ``tokens`` tokens whose attention
    lengths add up to ``context_sum`` (the config's count)."""
    f = cfg["flops"]
    return f["per_token"] * tokens + f["per_token_per_context"] * context_sum


def served_dtype(cfg: dict) -> Tuple[str, int]:
    """The configuration's dtype and its bytes an element."""
    dtype = cfg["model"].get("dtype", "bfloat16")
    return dtype, 4 if dtype == "float32" else 2


def wkv6_dims(cfg: dict) -> Tuple[int, int, int]:
    """(layers, heads, head size) of an RWKV-6 configuration."""
    m = cfg["model"]
    return m["n_layers"], m["n_heads"], m["d_model"] // m["n_heads"]


def wkv6_forward_work(B: int, T: int, H: int, D: int, itemsize: int,
                      with_state0: bool) -> Tuple[float, float]:
    """One forward call: 5 D^2 flops a (batch, head, step); r, k, v, w
    read and the output written once, u read, the state read (when
    given) and written once in float32."""
    n = B * T * H * D
    return (5.0 * B * H * T * D * D,
            5.0 * n * itemsize + 4 * H * D
            + (2 if with_state0 else 1) * 4.0 * B * H * D * D)

