"""K1 (`framed_conv1d`): its share of its roofline over the window (`_roofline`)."""

from ._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "framed_conv1d", "K1")
