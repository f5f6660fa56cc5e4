"""Mean ms of `PoseGraph.optimize` (`PoseGraph.times`), the 4-DoF PGO and
the drift update, over the window."""
UNIT = "ms"


def read(run):
    v = run.probes.pgo_ms
    return sum(v) / len(v) if v else None
