"""Port losses and metrics (ops/losses.py, ops/metrics.py) against the JAX
package's.

The same logits and labels, made with numpy, go through both.  Loss values
and their logit gradients are held at 1e-6 (f32 on both sides, only the
order of a few sums differs); the confusion matrix and the metrics derived
from it must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops import losses as jl
from multimodalaggressionrecognition_tpu.ops import metrics as jm
from multimodalaggressionrecognition_tpu_torch.ops import losses as tl
from multimodalaggressionrecognition_tpu_torch.ops import metrics as tm

TOL = 1e-6
ALPHA = (0.3, 0.7)


def _inputs(mask_kind, n=9, classes=2, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, classes)) * 2).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    mask = {"none": None,
            "rows": (rng.uniform(size=n) > 0.4).astype(np.float32),
            "all": np.zeros(n, np.float32)}[mask_kind]
    return logits, labels, mask


def _jax_loss(kind):
    return {"ce": lambda lg, y, m: jl.cross_entropy(lg, y, m),
            "weighted_ce": lambda lg, y, m: jl.weighted_cross_entropy(
                lg, y, jnp.asarray(ALPHA), m),
            "focal": lambda lg, y, m: jl.focal_loss(
                lg, y, alpha=jnp.asarray(ALPHA), gamma=2.0, row_mask=m)}[kind]


def _port_loss(kind):
    return {"ce": lambda lg, y, m: tl.cross_entropy(lg, y, m),
            "weighted_ce": lambda lg, y, m: tl.weighted_cross_entropy(
                lg, y, ALPHA, m),
            "focal": lambda lg, y, m: tl.focal_loss(
                lg, y, alpha=ALPHA, gamma=2.0, row_mask=m)}[kind]


@pytest.mark.parametrize("mask_kind", ["none", "rows", "all"])
@pytest.mark.parametrize("kind", ["ce", "weighted_ce", "focal"])
def test_loss_and_logit_gradient_match_jax(kind, mask_kind):
    logits, labels, mask = _inputs(mask_kind, seed=len(kind))
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(_jax_loss(kind))(
        jnp.asarray(logits), jnp.asarray(labels), jmask)
    lg = torch.from_numpy(logits).requires_grad_()
    got = _port_loss(kind)(lg, torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), atol=TOL)
    if mask_kind == "all":
        assert got.item() == 0.0 and not lg.grad.abs().any()


def test_masked_head_loss_skips_invalid_heads():
    heads = {"a": (torch.tensor(1.5), torch.tensor(1.0)),
             "b": (torch.tensor(7.0), torch.tensor(0.0))}
    want = jl.masked_head_loss({k: (float(a), float(b))
                                for k, (a, b) in heads.items()})
    assert tl.masked_head_loss(heads).item() == want == 1.5


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_and_metrics_equal_jax(masked):
    rng = np.random.default_rng(4)
    preds = rng.integers(0, 3, 40).astype(np.int32)
    labels = rng.integers(0, 3, 40).astype(np.int32)
    labels[labels == 2] = 1  # class 2 never true: a zero-division column
    mask = (rng.uniform(size=40) > 0.3).astype(np.float32) if masked else None
    want = np.asarray(jm.confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), 3,
        None if mask is None else jnp.asarray(mask)))
    got = tm.confusion_matrix(torch.from_numpy(preds),
                              torch.from_numpy(labels), 3,
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    a, b = tm.metrics_from_confusion(got.numpy()), jm.metrics_from_confusion(
        want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    empty = tm.metrics_from_confusion(np.zeros((2, 2)))
    assert empty["accuracy"] == 0.0 and empty["UAR"] == 0.0
