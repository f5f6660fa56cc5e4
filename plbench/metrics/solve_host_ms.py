"""Host ms a published frame inside `Estimator.process_frame` and
`finalize` (their wall time, waits on the card included), over the window
outside its traced part."""
UNIT = "ms"


def read(run):
    n = run.probes.counts["published"]
    return 1e3 * run.probes.host_s["solve"] / n if n else None
