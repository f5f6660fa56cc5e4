"""The LK kernel's share of its roofline: the least time of a track (the
copied bound at the window's sampled calls' inputs, their mean) over the
kernel's mean device time a launch in the traced part, in %."""
UNIT = "%"


def read(run):
    from plbench import trace

    if run.summary is None or run.lk_bound_s is None:
        return None
    s, n = trace.kernel(run.summary, "lk_track")
    return 100.0 * run.lk_bound_s / (s / n) if n and s > 0 else None
