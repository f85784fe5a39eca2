"""Adam and the EMA update on the card (`step.optimizer` device
phase), ms a step."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "step.optimizer")
