"""A kernel's share of its roofline over the window: the sum of its
launches' least times (`yardstick/launches.py` at the configuration's
shapes, `yardstick/peaks.py`) over its device time in the trace, the
kernels found by the frozen name rules (`yardstick/families.py`).  Nothing
to read (None) where the step launches no such kernel, the trace shows
none, or the port's launch count per step differs from the plan's."""

from ..yardstick.families import family
from ..yardstick.launches import bound_per_step, expected_counts


def roofline_pct(run, kernel: str, fam: str):
    if run.kernels is None or not run.steps:
        return None
    suffix = ".bf16" if (run.job["compute_dtype"] == "bfloat16"
                         and kernel != "framed_conv1d") else ""
    key = kernel + suffix
    bound = bound_per_step(run.card, run.cfg, run.job, key)
    if bound is None:
        return None
    expected = expected_counts(run.cfg, run.job)[key]
    if abs(run.launches_per_step.get(key, 0.0) - expected) > 1e-9:
        return None
    device_ns = sum(d for name, _, d in run.kernels if family(name) == fam)
    if device_ns <= 0:
        return None
    return 100.0 * bound * run.steps / (device_ns / 1e9)
