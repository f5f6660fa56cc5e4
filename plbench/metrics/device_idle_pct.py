"""The share of the traced part of the window in which no operation ran on
the card, in %."""
UNIT = "%"


def read(run):
    if run.summary is None or run.summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.summary["window_s"])
