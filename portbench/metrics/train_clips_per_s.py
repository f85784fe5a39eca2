"""All clips trained in the window over the window's wall time (host
clock; the window closes after the epoch's readback)."""


def read(run):
    return run.clips / run.window_s if run.window_s > 0 and run.steps else None
