"""The host's forward dispatch (`step.forward`, the bf16 casts
`step.cast` inside it), ms a step."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "step.forward")
