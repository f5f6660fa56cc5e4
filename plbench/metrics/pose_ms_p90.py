"""The 90th percentile, over the window's published frames that got a
pose, of the time from the frame's turn in the runner (the point frontend
takes it) to its pose on the host (the emitted, drift-corrected pose when
the pose graph runs). The deferred solve's frame of lag is in it."""
import statistics

UNIT = "ms"


def read(run):
    lat = run.probes.frames()[3]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
