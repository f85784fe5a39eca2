"""The 90th percentile of the intervals between consecutive step-start CUDA
events on the card's timeline, over every step of the window."""

import statistics


def read(run):
    if len(run.step_intervals_ms) < 10:
        return None
    return statistics.quantiles(run.step_intervals_ms, n=10)[-1]
