"""Camera frames completed in the window over the window's seconds: each
published frame whose outcome (a pose, or none) reached the host inside the
window completes the camera frames of its stride."""
UNIT = "frames/s"


def read(run):
    _, _, camera, _ = run.probes.frames()
    return camera / run.window_s if run.window_s > 0 else None
