"""`pose_ms_p90` of the loop cell, read in its traced run over the window's
part before the profiler starts. The loop cell's card idles ~80 % of the
window and its tail swings with the keyframes that pay the pose graph (a
spread of up to 21 % between runs), too wide for an end-to-end bound: it
stands here, moving `frames_per_s`."""
import statistics

UNIT = "ms"


def read(run):
    lat = run.probes.frames(untraced=True)[3]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
