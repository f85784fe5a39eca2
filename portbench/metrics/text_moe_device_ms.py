"""The GigaChat tower's MoE blocks on the card, ms a step: routing,
dispatch, the held experts' grouped products, combine and the shared
expert, forward (`forward.text.moe` device phases) and backward (each
segment from the prehook on a block's output to the one on its input
norm's, the held experts' recompute inside it)."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "forward.text.moe", "backward.text.moe")
