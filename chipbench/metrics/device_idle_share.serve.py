"""The share of the traced stretch in which no operation ran on the
card: 1 - the union of its kernels' and copies' intervals over the
stretch's wall time, both from the same trace."""


def read(run):
    st = run.stretch
    if st is None or st.seconds <= 0 or not st.ops:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.seconds)
