"""Seconds from process start to the window's first batch."""


def read(run):
    return run.setup_s
