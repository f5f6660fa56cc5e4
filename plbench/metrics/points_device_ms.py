"""Device ms a camera frame of the operations launched under the point
frontend's span (`FrontendPoints.process`), in the traced part."""
UNIT = "ms"


def read(run):
    return run.device_ms("points", "camera")
