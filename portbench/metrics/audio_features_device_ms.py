"""The XLS-R tower's frozen conv feature encoder on the card, ms a step
(`forward.audio.features` device phase; it has no backward)."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "forward.audio.features")
