"""Seconds from the process's start to the window's opening: loading,
building the kernels where none is built, weights, warm-up."""
import math


def read(run):
    return None if math.isnan(run.setup_s) else run.setup_s
