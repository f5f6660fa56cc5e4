"""Host ms a camera frame in the runner's loader: PNG decode
(`EurocSequence.image`) and CLAHE (`runner._clahe`), on the loader's thread,
over the window outside its traced part."""
UNIT = "ms"


def read(run):
    n = run.probes.counts["decode"]
    return 1e3 * run.probes.host_s["decode"] / n if n else None
