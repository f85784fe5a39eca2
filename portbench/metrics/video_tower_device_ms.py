"""The Swin tower on the card, ms a step: its forward (`forward.video`
device phase) and its backward segment (from the prehook on the tower
output's `grad_fn` to the next tower's; the recompute with remat)."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "forward.video", "backward.video")
