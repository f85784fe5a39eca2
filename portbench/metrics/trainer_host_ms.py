"""The host's mean time in each `Trainer.train_step` call of the window
(the benchmark's span around the call): the host's cost per step."""

import statistics


def read(run):
    return statistics.fmean(run.host_spans_s) * 1e3 if run.host_spans_s \
        else None
