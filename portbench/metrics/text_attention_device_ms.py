"""The GigaChat tower's latent attention (MLA) blocks on the card, ms a
step: their forwards (`forward.text.attention` device phases, the norm
before each outside) and their backward segments (each from the prehook on
a block's output to the one on its input norm's)."""

from ._spans import device_ms


def read(run):
    return device_ms(run, "forward.text.attention", "backward.text.attention")
