"""A kernel's share of its roofline over the window: the sum of its
launches' least times (the launch plan of the configuration's model at its
shapes, `yardstick/peaks.py`) over its device time in the trace, the
kernels found by the model's name rules ahead of the frozen ones
(`yardstick/families.py`).  A kernel's launches are the plan's keys
`<kernel>` and `<kernel>.<dtype>`.  Nothing to read (None) where the step
launches no such kernel, the trace shows none, or the port's launch count
per step differs from the plan's."""

from .. import models
from ..yardstick.launches import bound_per_step, expected_counts


def roofline_pct(run, kernel: str, fam: str):
    if run.kernels is None or not run.steps:
        return None
    expected = expected_counts(run.cfg, run.job)
    keys = [k for k in expected if k.split(".")[0] == kernel]
    bounds = [bound_per_step(run.card, run.cfg, run.job, k) for k in keys]
    if not keys or None in bounds:
        return None
    if any(abs(run.launches_per_step.get(k, 0.0) - expected[k]) > 1e-9
           for k in keys):
        return None
    family = models.family_of(run.cfg)
    device_ns = sum(d for name, _, d in run.kernels if family(name) == fam)
    if device_ns <= 0:
        return None
    return 100.0 * sum(bounds) * run.steps / (device_ns / 1e9)
