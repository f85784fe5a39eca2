"""The XLS-R audio tower on the card, ms a step: its forward (`forward.audio`
device phase) and every backward segment of the tower (from the prehook on
the tower output's `grad_fn` through the positional conv's and the
projection's segments to the backward's end).  None for a tower without
the positional conv's span."""

from ._spans import device_ms


def read(run):
    if device_ms(run, "forward.audio.pos_conv") is None:
        return None
    return device_ms(run, "forward.audio", "backward.audio",
                     "backward.audio.pos_conv", "backward.audio.projection")
