"""The host waiting for the card in the trainer's throttle
(`train.throttle`: `_InflightThrottle.push` and its wait on an older
step's event), host ms a step."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "train.throttle")
