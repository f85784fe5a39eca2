"""Metric accumulation (the JAX package's ops/metrics.py).

The per-batch statistic is a (C, C) confusion matrix kept on the device
(one one-hot matmul per batch); the epoch's metrics come from the summed
matrix on the host, with sklearn's zero_division=0 semantics: accuracy,
per-class precision, recall and F1, and their means UAR, UAP and UAF1.
"""

import numpy as np
import torch


def confusion_matrix(preds, labels, num_classes: int, row_mask=None):
    """(C, C) f32 confusion matrix, rows = true class, cols = predicted."""
    true_oh = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    pred_oh = torch.nn.functional.one_hot(preds.long(), num_classes).float()
    if row_mask is not None:
        true_oh = true_oh * row_mask.float()[:, None]
    return true_oh.T @ pred_oh


def metrics_from_confusion(cm):
    """The reference's logged metric dict from a confusion matrix:
    {'accuracy', 'precision' (per class), 'recall', 'f1', 'UAR', 'UAP',
    'UAF1'} as numpy values."""
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    tp = np.diag(cm)
    pred_count = cm.sum(axis=0)
    true_count = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(true_count > 0, tp / true_count, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    accuracy = tp.sum() / total if total > 0 else 0.0
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "UAR": recall.mean(),
        "UAP": precision.mean(),
        "UAF1": f1.mean(),
    }
