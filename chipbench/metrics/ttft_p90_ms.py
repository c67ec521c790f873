"""The 90th percentile of time to first token over all requests whose
first token arrived inside the window: from the moment the client sent
it to the return of ``Engine.admit``, the token on the host.  A window
holds 145-160 first tokens of long prompts, so at least 14 lie beyond
the 90th percentile (beyond a 95th, 7-8)."""
from chipbench.readers import percentile, ttfts_ms


def read(run):
    return percentile(ttfts_ms(run), 90)
