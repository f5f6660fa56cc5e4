"""Process start to the window's opening: imports, the kernels' load (their
build on a checkout's first run), the recording's render or reuse, and the
replay through initialization and the warm-up solves, which capture the
CUDA graphs."""
UNIT = "s"


def read(run):
    return run.setup_s
