"""K4 (`roll`): its share of its roofline over the window (`_roofline`)."""

from ._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "roll", "K4")
