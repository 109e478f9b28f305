"""h2d_GBps.<mix>: host-to-card copies in the window, their bytes over
their device time (CUPTI's memcpy records in the profiler trace)."""


def read(ctx):
    if ctx.trace is None:
        return None
    copies = ctx.trace.copies("Memcpy HtoD")
    nbytes = sum(float(e["args"].get("bytes", 0)) for e in copies)
    secs = sum(float(e["dur"]) for e in copies) / 1e6
    return None if not nbytes or not secs else nbytes / secs / 1e9
