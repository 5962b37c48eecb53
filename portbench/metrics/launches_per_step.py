"""Device operations a step over the traced chunk: the profiler's kernel,
copy and set records, each kernel's scaled to the launches its records
stand for (the profiler drops some; the run prints how many)."""


def read(run):
    t = run.trace
    if t is None or not t["stands_for"]:
        return None
    return sum(t["stands_for"].values()) / t["steps"]
