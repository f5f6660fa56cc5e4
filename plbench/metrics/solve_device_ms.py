"""Device ms a published frame of the operations launched under the
estimator's span (`Estimator.process_frame` and `finalize`: feature tables,
preintegration, the backend tick's triangulation, LM solve and
marginalization), in the traced part."""
UNIT = "ms"


def read(run):
    return run.device_ms("solve", "published")
