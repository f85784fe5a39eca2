"""Train and eval steps (the JAX package's train/steps.py).

One backward over the sum of the per-head masked losses (the reference's
per-head `backward(retain_graph=True)` chain gives the same gradients
through the shared trunk).  Per-batch metrics are confusion matrices kept
on the device; nothing is read back per step.

Batch layout (data/avabos.py `build_batch`, as tensors on the device):
  {'modalities': {m: {'data', 'present'}}, 'labels': {head: (B,)},
   'label_mask': {head: (B,)}, 'sample_mask': (B,)}

A head whose `label_mask` is all zero contributes zero loss.

On a data-parallel mesh (`state.mesh`) each rank steps on its rows of the
global batch; the loss denominators are the global batch's
(`head_losses_and_metrics`), and the optimizer sums the gradients over the
data group (train/state.py), so the step is the one-process step.

`compute_dtype` "bfloat16" (JAX train/steps.py's mixed precision): master
parameters, optimizer state, gradients, BatchNorm running statistics,
losses and metrics stay f32; inside the step the floating parameters and
the modality inputs are cast to bf16 and the model runs on the casts
(`torch.func.functional_call`), so the gradients land on the f32 masters
through the differentiable cast.  Logits are upcast to f32 before the
losses.  This is not `torch.autocast`, whose per-op lists compute another
function than the JAX package's.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..ops import losses as L
from ..ops.metrics import confusion_matrix
from ..utils.precision import cast_floating, resolve_dtype
from ..utils.profiling import span


@dataclass(frozen=True)
class LossSpec:
    kind: str = "ce"  # 'ce' | 'weighted_ce' | 'focal'
    class_weights: Optional[tuple] = None
    gamma: float = 2.0

    def terms(self, logits, labels, row_mask):
        """(numerator, denominator, floor) of the loss (ops/losses.py)."""
        if self.kind == "ce":
            return L.cross_entropy_terms(logits, labels, row_mask)
        if self.kind == "weighted_ce":
            return L.weighted_cross_entropy_terms(
                logits, labels, self.class_weights, row_mask)
        if self.kind == "focal":
            return L.focal_loss_terms(logits, labels, alpha=self.class_weights,
                                      gamma=self.gamma, row_mask=row_mask)
        raise ValueError(f"unknown loss kind {self.kind!r}")

    def __call__(self, logits, labels, row_mask):
        return L.reduce_terms(*self.terms(logits, labels, row_mask))


class SingleHeadAdapter(nn.Module):
    """A single-input model `inner` (data -> logits) in the batch protocol:
    modalities -> {head: inner(modalities[modality]['data'])}."""

    def __init__(self, inner: nn.Module, modality: str, head: str = "main"):
        super().__init__()
        self.inner, self.modality, self.head = inner, modality, head

    def forward(self, modalities):
        return {self.head: self.inner(modalities[self.modality]["data"])}


class MultiHeadAdapter(nn.Module):
    """A single-input model `inner` (data -> {head: logits}) in the batch
    protocol: modalities -> inner(modalities[modality]['data'])."""

    def __init__(self, inner: nn.Module, modality: str):
        super().__init__()
        self.inner, self.modality = inner, modality

    def forward(self, modalities):
        return self.inner(modalities[self.modality]["data"])


def head_losses_and_metrics(outputs, batch, loss_specs: Dict[str, LossSpec],
                            num_classes: int, group=None):
    """(summed loss, {head: {'loss', 'valid', 'confusion'}}) over the heads
    that carry labels in this batch; logits in f32, and a head counts only
    when it has a valid row.

    With a data-parallel `group` the batch is this rank's rows of a global
    batch: every head's numerator, denominator and valid count are summed
    over the group in one all-reduce on the device (no host sync), the
    `valid > 0` gate reads the global count, and each head's loss is the
    global one.  The returned sum is this rank's share, the local
    numerator over the global denominator: the shares sum to the global
    loss, so the group's summed gradients are the one-process gradient.
    The confusion matrices stay this rank's (the trainer sums them once an
    epoch)."""
    heads, parts = [], []
    for head, logits in outputs.items():
        if head not in batch["labels"]:
            continue
        logits = logits.float()
        labels = batch["labels"][head]
        mask = batch["label_mask"][head]
        num, den, floor = loss_specs[head].terms(logits, labels, mask)
        cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes,
                              row_mask=mask)
        heads.append((head, num, floor, cm))
        parts.append(torch.stack([num.detach(), den.to(num.dtype),
                                  mask.sum().to(num.dtype)]))
    if not heads:
        return 0.0, {}
    sums = torch.stack(parts)
    if group is not None:
        from ..parallel.mesh import all_reduce_

        sums = all_reduce_(sums, group)
    total = 0.0
    metrics = {}
    for i, (head, num, floor, cm) in enumerate(heads):
        global_num, den, valid = sums[i]
        loss = torch.where(valid > 0, L.reduce_terms(num, den, floor), 0.0)
        reported = torch.where(
            valid > 0, L.reduce_terms(global_num, den, floor), 0.0)
        total = total + loss
        metrics[head] = {"loss": reported, "valid": valid, "confusion": cm}
    return total, metrics


def total_loss(metrics):
    """The summed head losses of head_losses_and_metrics' metrics."""
    return sum(m["loss"] for m in metrics.values())


def forward(model, modalities, compute_dtype=None, params=None):
    """model(modalities), run on `params` ({name: tensor}, replacing the
    model's own; the EMA shadow) and in `compute_dtype`: the floating
    parameters and inputs cast to it.  Buffers (BatchNorm's running
    statistics) are the model's own, f32."""
    dtype = resolve_dtype(compute_dtype)
    if dtype == torch.float32:
        dtype = None
    if dtype is None and not params:
        return model(modalities)
    full = dict(model.named_parameters())
    full.update(params or {})
    with span("step.cast", device=True):
        full = cast_floating(full, dtype)
        modalities = cast_floating(modalities, dtype)
    return functional_call(model, full, (modalities,))


def train_step(state, batch, loss_specs, num_classes: int,
               compute_dtype=None):
    """Forward in train mode, one backward, one optimizer step (or, under
    accumulation, one micro-step); BatchNorm running statistics move in the
    forward; the EMA shadow moves after each real update.  Returns the
    metrics (device tensors)."""
    model, optimizer = state.model, state.optimizer
    with span("step", state.step, device=True):
        with span("step.forward"):
            model.train()
            outputs = forward(model, batch["modalities"], compute_dtype)
        with span("step.loss", device=True):
            total, metrics = head_losses_and_metrics(
                outputs, batch, loss_specs, num_classes, state.dp_group())
            metrics["total_loss"] = total_loss(metrics)
        with span("step.backward", device=True):
            # zeroed here, by the backward that refills them
            with span("step.zero_grad"):
                optimizer.zero_grad()
            total.backward()
        # heads without labels still move, on zero gradients
        with span("step.optimizer", device=True):
            if optimizer.step():
                state.update_ema()
        state.step += 1
    return metrics


@torch.no_grad()
def eval_step(state, batch, loss_specs, num_classes: int,
              compute_dtype=None):
    """The eval-mode model (BatchNorm folded, the stem's epilogue fused),
    on the EMA shadow when one is tracked."""
    state.model.eval()
    _, metrics = head_losses_and_metrics(
        forward(state.model, batch["modalities"], compute_dtype,
                state.eval_params()),
        batch, loss_specs, num_classes, state.dp_group())
    metrics["total_loss"] = total_loss(metrics)
    return metrics
