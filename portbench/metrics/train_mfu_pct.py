"""The model's operations per step (`yardstick/flops.py`, counted over
the plain reference) over the time per step and the compute dtype's
published peak (`yardstick/peaks.train_peak`)."""

from ..yardstick.peaks import train_peak


def read(run):
    if not run.flops_per_step or not run.steps or not run.window_s:
        return None
    peak = train_peak(run.card, run.job["compute_dtype"])
    return 100.0 * run.flops_per_step * run.steps / (run.window_s * peak)
