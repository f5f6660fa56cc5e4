"""Mean ms of `PoseGraph.add_keyframe` (`PoseGraph.times`) over the window
outside its traced part: keyframe features, the database query, the BRIEF
search and PnP of each candidate."""
UNIT = "ms"


def read(run):
    v = run.probes.kf_ms
    return sum(v) / len(v) if v else None
