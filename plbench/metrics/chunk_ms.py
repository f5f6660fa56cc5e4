"""Mean host ms of a burst chunk: the runner's `burst_log` `chunk_s` (its B
device steps launched and its one readback, the wait for the decoded frames
excluded), over the chunks that ran inside the window and ended before the
profiler started."""
UNIT = "ms"


def read(run):
    v = [e["chunk_s"] for e in run.probes.chunks()]
    return 1e3 * sum(v) / len(v) if v else None
