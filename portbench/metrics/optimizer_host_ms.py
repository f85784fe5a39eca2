"""The host in the optimizer step and the EMA update
(`step.optimizer`), ms a step."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "step.optimizer")
