"""Train and eval steps (the JAX package's train/steps.py).

One backward over the sum of the per-head masked losses (the reference's
per-head `backward(retain_graph=True)` chain gives the same gradients
through the shared trunk).  Per-batch metrics are confusion matrices kept
on the device; nothing is read back per step.

Batch layout (data/avabos.py `build_batch`, as tensors on the device):
  {'modalities': {m: {'data', 'present'}}, 'labels': {head: (B,)},
   'label_mask': {head: (B,)}, 'sample_mask': (B,)}

A head whose `label_mask` is all zero contributes zero loss.  f32 only: a
bf16 compute dtype is not ported.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..ops import losses as L
from ..ops.metrics import confusion_matrix


@dataclass(frozen=True)
class LossSpec:
    kind: str = "ce"  # 'ce' | 'weighted_ce' | 'focal'
    class_weights: Optional[tuple] = None
    gamma: float = 2.0

    def __call__(self, logits, labels, row_mask):
        if self.kind == "ce":
            return L.cross_entropy(logits, labels, row_mask)
        if self.kind == "weighted_ce":
            return L.weighted_cross_entropy(logits, labels, self.class_weights,
                                            row_mask)
        if self.kind == "focal":
            return L.focal_loss(logits, labels, alpha=self.class_weights,
                                gamma=self.gamma, row_mask=row_mask)
        raise ValueError(f"unknown loss kind {self.kind!r}")


def head_losses_and_metrics(outputs, batch, loss_specs: Dict[str, LossSpec],
                            num_classes: int):
    """(summed loss, {head: {'loss', 'valid', 'confusion'}}) over the heads
    that carry labels in this batch; logits in f32, and a head counts only
    when it has a valid row."""
    total = 0.0
    metrics = {}
    for head, logits in outputs.items():
        if head not in batch["labels"]:
            continue
        logits = logits.float()
        labels = batch["labels"][head]
        mask = batch["label_mask"][head]
        valid = mask.sum()
        loss = loss_specs[head](logits, labels, mask)
        loss = torch.where(valid > 0, loss, 0.0)
        total = total + loss
        cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes,
                              row_mask=mask)
        metrics[head] = {"loss": loss.detach(), "valid": valid,
                         "confusion": cm}
    return total, metrics


def train_step(state, batch, loss_specs, num_classes: int):
    """Forward in train mode, one backward, one optimizer step; BatchNorm
    running statistics move in the forward.  Returns the metrics (device
    tensors)."""
    model, optimizer = state.model, state.optimizer
    model.train()
    optimizer.zero_grad(set_to_none=False)
    total, metrics = head_losses_and_metrics(
        model(batch["modalities"]), batch, loss_specs, num_classes)
    total.backward()
    optimizer.step()  # heads without labels still move, on zero gradients
    state.step += 1
    metrics["total_loss"] = total.detach()
    return metrics


@torch.no_grad()
def eval_step(state, batch, loss_specs, num_classes: int):
    """The eval-mode model (BatchNorm folded, the stem's epilogue fused)."""
    state.model.eval()
    total, metrics = head_losses_and_metrics(
        state.model(batch["modalities"]), batch, loss_specs, num_classes)
    metrics["total_loss"] = total
    return metrics
