"""The 95th percentile over all gaps between consecutive output tokens
of one request, of every gap that ends inside the window."""
from chipbench.readers import percentile


def read(run):
    gaps = [ns / 1e6 for s in run.requests for end, ns in s.gaps
            if run.in_window(end)]
    return percentile(gaps, 95)
