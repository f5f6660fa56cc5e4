"""Device ms a published frame of the operations launched under the
estimator's span (`Estimator.process_frame` and `finalize`: feature tables,
preintegration, the backend tick's triangulation, LM solve and
marginalization; in a burst step, `BurstStep.step` less its frontends:
the device feature tables, preintegration, the same backend tick, failure
detection and the slide), in the traced part."""
UNIT = "ms"


def read(run):
    return run.device_ms("solve", "published")
