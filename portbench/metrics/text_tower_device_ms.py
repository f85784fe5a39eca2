"""The GigaChat text tower on the card, ms a step: its forward
(`forward.text` device phase) and every backward segment of the tower (from
the prehook on the tower output's `grad_fn` through its layers' attention,
MoE and norm segments to the backward's next tower).  None for a text tower
without MoE blocks' spans."""

from ._spans import device_ms


def read(run):
    if device_ms(run, "forward.text.moe") is None:
        return None
    return device_ms(run, "forward.text", "backward.text",
                     "backward.text.attention", "backward.text.moe")
