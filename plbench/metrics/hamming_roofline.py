"""The Hamming kernel's share of its roofline: the least time of each
launch in the traced part (the copied bound at its shapes), summed, over the
kernel's device time there, in %. Launches of the line matcher and of the
keyframe search together."""
UNIT = "%"


def read(run):
    from plbench import bounds, trace

    if run.summary is None:
        return None
    s, n = trace.kernel(run.summary, "hamming")
    shapes = run.probes.hamming_shapes
    if not n or s <= 0 or n != len(shapes):
        return None
    return 100.0 * sum(bounds.hamming_bound_s(a, b) for a, b in shapes) / s
