"""The model's operations in one training step, counted by
`torch.utils.flop_counter.FlopCounterMode` over the step that the
configuration's model gives on the meta device at the cell's shapes
(`meta_step`; the PhysVerb model's is the plain reference's: the forward
and backward of the parts that train, the forward alone of a frozen tower,
and nothing recomputed).  The count does not depend on what implements the
step."""

from .. import models


def step_flops(cfg, job) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    step = models.load(cfg).meta_step(cfg, job)
    with FlopCounterMode(display=False) as counter:
        step()
    return float(counter.get_total_flops())
