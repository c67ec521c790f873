"""The median time to first token of the requests whose first token
arrived inside the window (tens of requests a window: a median, not a
tail)."""
from chipbench.readers import median, ttfts_ms


def read(run):
    return median(ttfts_ms(run))
