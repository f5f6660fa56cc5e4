"""Device ms a published frame of the operations launched under the line
frontend's span (`FrontendLines.process`; in a burst step the line tick,
`frontend_lines.tick`), in the traced part."""
UNIT = "ms"


def read(run):
    return run.device_ms("lines", "published")
