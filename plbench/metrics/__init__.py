"""One reader a metric, found by the metric's name in BENCHMARK.json: a
module `<name>.py` with `UNIT` and `read(run)`, which returns the value, or
None where the run gave it nothing to read (the harness then leaves the
metric out). `run` is the harness's `plbench.run.Run`."""
