"""The traced chunk's share of wall time in which no operation ran on the
card, in %: one less the device's busy seconds (one stream: the sum of
its operations' times) over the chunk's wall seconds."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
