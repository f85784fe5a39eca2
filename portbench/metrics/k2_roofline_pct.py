"""K2 (`window_attention`): its share of its roofline over the window (`_roofline`)."""

from ._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "window_attention", "K2")
