"""Masked multi-head classification losses (the JAX package's ops/losses.py).

Every head loss takes a static-shape {0,1} row mask and reduces as
sum(loss_i * m_i) / max(sum(m_i), 1).  The focal loss follows the hub
implementation the reference pulled at run time: per sample
ce_i = -alpha[y_i] * log p_i[y_i], focal_i = (1 - p_i[y_i])**gamma * ce_i.
`weighted_cross_entropy` is torch.nn.CrossEntropyLoss(weight=w): the masked
sum of w_y * nll over the summed weights of the targets.  Labels may be any
integer dtype.

Each loss is a numerator over a denominator (`*_terms`: the masked sum,
the valid count or the summed target weights, and the denominator's
floor), so a data-parallel step can sum both over its ranks and divide
once: the global batch's loss, as GSPMD's reduction gives it
(train/steps.py).

The class weights are gathered from a table on the logits' device
(`class_weight_table`), built once per (weights, dtype, device) and kept
for the life of the process: making a CUDA tensor from a Python tuple is a
pageable copy that waits for the card to drain its queue, which every step
would otherwise pay.  `TABLE_COUNTS` counts the builds and the hits
(utils/profiling.Recording reads both over a window).
"""

import threading

import torch

_tables = {}  # (weights tuple, dtype, device) -> the table on that device
_tables_lock = threading.Lock()
TABLE_COUNTS = {"builds": 0, "hits": 0}


def _log_softmax_gather(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def class_weight_table(weights, dtype, device):
    """`weights` (a tuple or list of per-class weights) as a `dtype` tensor
    on `device`: built with one copy on first use, the same tensor after.
    A tensor is used as it is, moved with `.to(dtype, device)`."""
    if isinstance(weights, torch.Tensor):
        return weights.to(dtype=dtype, device=device)
    key = (tuple(weights), dtype, torch.device(device))
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            table = torch.as_tensor(key[0], dtype=dtype, device=device)
            _tables[key] = table
            TABLE_COUNTS["builds"] += 1
        else:
            TABLE_COUNTS["hits"] += 1
    return table


def _masked_terms(loss, row_mask):
    """(numerator, denominator, floor) of the masked mean
    sum(loss * m) / max(sum(m), floor)."""
    if row_mask is None:
        # filled on the device: a host scalar would be a blocking copy
        count = torch.full((), float(loss.numel()), dtype=loss.dtype,
                           device=loss.device)
        return loss.sum(), count, 1.0
    row_mask = row_mask.to(loss.dtype)
    return (loss * row_mask).sum(), row_mask.sum(), 1.0


def reduce_terms(num, den, floor):
    return num / den.clamp(min=floor)


def cross_entropy_terms(logits, labels, row_mask=None):
    return _masked_terms(-_log_softmax_gather(logits, labels), row_mask)


def weighted_cross_entropy_terms(logits, labels, class_weights,
                                 row_mask=None):
    nll = -_log_softmax_gather(logits, labels)
    w = class_weight_table(class_weights, nll.dtype,
                           nll.device)[labels.long()]
    if row_mask is not None:
        w = w * row_mask.to(w.dtype)
    return (nll * w).sum(), w.sum(), 1e-12


def focal_loss_terms(logits, labels, alpha=None, gamma: float = 2.0,
                     row_mask=None):
    logp_y = _log_softmax_gather(logits, labels)
    ce = -logp_y
    if alpha is not None:
        ce = ce * class_weight_table(alpha, ce.dtype,
                                     ce.device)[labels.long()]
    loss = (1.0 - logp_y.exp()) ** gamma * ce
    return _masked_terms(loss, row_mask)


def cross_entropy(logits, labels, row_mask=None):
    """Mean CE over (optionally masked) rows. logits (N, C), labels (N,)."""
    return reduce_terms(*cross_entropy_terms(logits, labels, row_mask))


def weighted_cross_entropy(logits, labels, class_weights, row_mask=None):
    """torch CrossEntropyLoss(weight=...) semantics: sum(w_y*nll)/sum(w_y)."""
    return reduce_terms(*weighted_cross_entropy_terms(
        logits, labels, class_weights, row_mask))


def focal_loss(logits, labels, alpha=None, gamma: float = 2.0, row_mask=None):
    """Multi-class focal loss (hub semantics: alpha on the CE term)."""
    return reduce_terms(*focal_loss_terms(logits, labels, alpha, gamma,
                                          row_mask))


def masked_head_loss(head_losses: dict):
    """Total scalar loss from a {head: (loss, valid)} dict; a head whose
    `valid` is 0 contributes nothing."""
    total = 0.0
    for loss, valid in head_losses.values():
        total = total + loss * valid
    return total
