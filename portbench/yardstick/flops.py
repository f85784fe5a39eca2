"""The model's operations in one training step, counted by
`torch.utils.flop_counter.FlopCounterMode` over the plain reference on the
meta device at the cell's shapes: the forward and backward of the parts
that train, the forward alone of a frozen tower, and nothing recomputed.
The count does not depend on what implements the step."""

import torch

from ..inputs import batch_shapes
from ..reference import model as M
from ..reference.train import ReferenceTrainer
from .launches import HEADS, job_modalities


def step_flops(cfg, job) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    batch = job["batch_size"]
    modalities = job_modalities(cfg, job)
    heads = HEADS[job["aggr_type"]]
    meta = torch.device("meta")
    weights = {n: torch.empty(shape, device=meta)
               for n, shape, _ in M.parameter_spec(cfg, modalities)}
    trains = "video" in modalities and not job["video_freeze"]
    ref = ReferenceTrainer(weights, cfg, modalities, trains)
    mods = {m: {"data": torch.empty(s, device=meta),
                "present": torch.empty(batch, device=meta)}
            for m, s in batch_shapes(cfg, modalities, batch).items()}
    b = {"modalities": mods,
         "labels": {h: torch.empty(batch, dtype=torch.int32, device=meta)
                    for h in heads},
         "label_mask": {h: torch.empty(batch, device=meta) for h in heads}}
    masks = {k: (torch.empty(shape, device=meta), rate)
             for k, shape, rate in M.mask_shapes(cfg, modalities, batch,
                                                 trains)}
    with FlopCounterMode(display=False) as counter:
        ref.loss_and_grads(b, masks, whole=True)
    return float(counter.get_total_flops())
