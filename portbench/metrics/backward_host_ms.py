"""The host inside `total.backward()` (`step.backward`), ms a step."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "step.backward")
