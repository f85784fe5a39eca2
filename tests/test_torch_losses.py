"""Port losses and metrics (ops/losses.py, ops/metrics.py) against the JAX
package's.

The same logits and labels, made with numpy, go through both.  Loss values
and their logit gradients are held at 1e-6 (f32 on both sides, only the
order of a few sums differs); the confusion matrix and the metrics derived
from it must be equal.  The class weights come from a table built once per
(weights, dtype, device): the weighted terms and their logit gradients are
bit for bit those of the weights made into a tensor on every call.
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


def _inline_terms(kind, logits, labels, weights, row_mask):
    """The weighted terms with the weights made into a tensor in place, on
    every call: the formula the table replaces."""
    logp_y = torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[..., None])[..., 0]
    w = torch.as_tensor(weights, dtype=logp_y.dtype,
                        device=logp_y.device)[labels.long()]
    if kind == "weighted_ce":
        if row_mask is not None:
            w = w * row_mask.to(w.dtype)
        return (-logp_y * w).sum(), w.sum(), 1e-12
    loss = (1.0 - logp_y.exp()) ** 2.0 * (-logp_y * w)
    if row_mask is None:
        return loss.sum(), loss.new_tensor(float(loss.numel())), 1.0
    row_mask = row_mask.to(loss.dtype)
    return (loss * row_mask).sum(), row_mask.sum(), 1.0


def _port_terms(kind, logits, labels, weights, row_mask):
    if kind == "weighted_ce":
        return tl.weighted_cross_entropy_terms(logits, labels, weights,
                                               row_mask)
    return tl.focal_loss_terms(logits, labels, alpha=weights, gamma=2.0,
                               row_mask=row_mask)


@pytest.mark.parametrize("mask_kind", ["none", "rows"])
@pytest.mark.parametrize("container", ["tuple", "list", "tensor"])
@pytest.mark.parametrize("kind", ["weighted_ce", "focal"])
def test_weight_table_terms_and_gradients_are_bit_identical(kind, container,
                                                            mask_kind):
    logits, labels, mask = _inputs(mask_kind, n=11, seed=3)
    labels, mask = torch.from_numpy(labels), (
        None if mask is None else torch.from_numpy(mask))
    weights = {"tuple": ALPHA, "list": list(ALPHA),
               "tensor": torch.tensor(ALPHA, dtype=torch.float64)}[container]
    grads, terms = [], []
    for fn in (_inline_terms, _port_terms):
        lg = torch.from_numpy(logits).requires_grad_()
        num, den, floor = fn(kind, lg, labels, weights, mask)
        tl.reduce_terms(num, den, floor).backward()
        terms.append((num.detach(), den, floor))
        grads.append(lg.grad)
    (want_num, want_den, want_floor), (num, den, floor) = terms
    assert torch.equal(num, want_num) and torch.equal(den, want_den)
    assert floor == want_floor and den.dtype == want_den.dtype
    assert torch.equal(grads[1], grads[0])


def test_weight_table_is_built_once_per_weights_dtype_and_device():
    counts = tl.TABLE_COUNTS
    weights = (0.1234, 0.8766)  # no other test builds this table

    def delta(before):
        return (counts["builds"] - before[0], counts["hits"] - before[1])

    before = (counts["builds"], counts["hits"])
    table = tl.class_weight_table(weights, torch.float32, "cpu")
    assert delta(before) == (1, 0)
    assert torch.equal(table, torch.as_tensor(weights, dtype=torch.float32))
    assert tl.class_weight_table(list(weights), torch.float32,
                                 torch.device("cpu")) is table
    assert delta(before) == (1, 1)
    f64 = tl.class_weight_table(weights, torch.float64, "cpu")
    other = tl.class_weight_table((0.4321, 0.5679), torch.float32, "cpu")
    assert delta(before) == (3, 1)
    assert f64.dtype == torch.float64 and f64 is not table
    assert not torch.equal(other, table)
    given = torch.tensor(weights, dtype=torch.float64)
    assert torch.equal(tl.class_weight_table(given, torch.float32, "cpu"),
                       table)
    assert delta(before) == (3, 1)  # a tensor is used as it is
    logits, labels, _ = _inputs("none", seed=5)
    for _ in range(3):
        tl.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      alpha=weights)
    assert delta(before) == (3, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ce", "focal"])
def test_unmasked_denominator_is_the_row_count(kind, dtype):
    logits, labels, _ = _inputs("none", n=7, seed=2)
    logits = torch.from_numpy(logits).to(dtype)
    labels = torch.from_numpy(labels)
    if kind == "ce":
        num, den, floor = tl.cross_entropy_terms(logits, labels)
    else:
        num, den, floor = tl.focal_loss_terms(logits, labels, alpha=ALPHA)
    assert den.shape == () and den.dtype == num.dtype == dtype
    assert den.item() == 7.0 and floor == 1.0


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
