"""The card's peak allocated memory in the window (GiB), after a reset
of the peak at the window's opening."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
