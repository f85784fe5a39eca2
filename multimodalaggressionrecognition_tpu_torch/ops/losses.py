"""Masked multi-head classification losses (the JAX package's ops/losses.py).

Every head loss takes a static-shape {0,1} row mask and reduces as
sum(loss_i * m_i) / max(sum(m_i), 1).  The focal loss follows the hub
implementation the reference pulled at run time: per sample
ce_i = -alpha[y_i] * log p_i[y_i], focal_i = (1 - p_i[y_i])**gamma * ce_i.
`weighted_cross_entropy` is torch.nn.CrossEntropyLoss(weight=w): the masked
sum of w_y * nll over the summed weights of the targets.  Labels may be any
integer dtype.
"""

import torch


def _log_softmax_gather(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def _masked_mean(loss, row_mask):
    if row_mask is None:
        return loss.mean()
    row_mask = row_mask.to(loss.dtype)
    return (loss * row_mask).sum() / row_mask.sum().clamp(min=1.0)


def cross_entropy(logits, labels, row_mask=None):
    """Mean CE over (optionally masked) rows. logits (N, C), labels (N,)."""
    return _masked_mean(-_log_softmax_gather(logits, labels), row_mask)


def weighted_cross_entropy(logits, labels, class_weights, row_mask=None):
    """torch CrossEntropyLoss(weight=...) semantics: sum(w_y*nll)/sum(w_y)."""
    nll = -_log_softmax_gather(logits, labels)
    w = torch.as_tensor(class_weights, dtype=nll.dtype,
                        device=nll.device)[labels.long()]
    if row_mask is not None:
        w = w * row_mask.to(w.dtype)
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def focal_loss(logits, labels, alpha=None, gamma: float = 2.0, row_mask=None):
    """Multi-class focal loss (hub semantics: alpha on the CE term)."""
    logp_y = _log_softmax_gather(logits, labels)
    ce = -logp_y
    if alpha is not None:
        ce = ce * torch.as_tensor(alpha, dtype=ce.dtype,
                                  device=ce.device)[labels.long()]
    loss = (1.0 - logp_y.exp()) ** gamma * ce
    return _masked_mean(loss, row_mask)


def masked_head_loss(head_losses: dict):
    """Total scalar loss from a {head: (loss, valid)} dict; a head whose
    `valid` is 0 contributes nothing."""
    total = 0.0
    for loss, valid in head_losses.values():
        total = total + loss * valid
    return total
