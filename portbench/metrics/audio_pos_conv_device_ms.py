"""The XLS-R tower's weight-normed positional conv on the card, ms a step:
its forward (`forward.audio.pos_conv` device phase) and its backward
segment (from the prehook on its output's `grad_fn` to the projection's)."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "forward.audio.pos_conv", "backward.audio.pos_conv")
