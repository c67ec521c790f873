"""Every output token that reached its client inside the window (first
tokens from prefill and tokens from decode steps), over the window's
seconds."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    n = sum(1 for s in run.requests for t in s.times if run.in_window(t))
    return n / run.window_s
