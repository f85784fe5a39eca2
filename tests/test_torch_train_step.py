"""The port's train step on the whole tri-modal model against the JAX
package's, at tests/test_torch_trimodal.py's sizes (hidden 768, the real
Swin3D-T unfrozen, 16 frames at 32 px, 16 000 samples, 8 tokens), with the
same weights carried by io/from_jax.py.

With both models deterministic (JAX `train=False`, the port in eval mode)
the summed head loss of `_head_losses_and_metrics` (focal on 'phys', CE on
'verb') must agree within 1e-5 and every parameter's gradient within
1e-4 * max|g_JAX| of that tensor (f32; the Swin tower's long sums run in
another order).  One Adam step on the same gradients must match optax.adam
at 1e-6.  A port train step in train mode must lower the loss of a repeated
batch and move the BatchNorm running statistics.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_multimodal as ttm)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, adam, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics, train_step)
from test_torch_trimodal import MODALITIES, SIZES, batch, random_variables

ALPHA = (0.35, 0.65)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def labelled(n=3):
    """A tri-modal batch with both heads labelled, one label masked."""
    b = {"modalities": batch(n)}
    rng = np.random.default_rng(8)
    b["labels"] = {h: rng.integers(0, 2, n).astype(np.int32)
                   for h in ("phys", "verb")}
    b["label_mask"] = {"phys": np.ones(n, np.float32),
                       "verb": np.array([1.0] * (n - 1) + [0.0], np.float32)}
    b["sample_mask"] = np.ones(n, np.float32)
    return b


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def reference():
    """(variables, batch, JAX loss, JAX gradients) with the tower unfrozen."""
    cfg = jtm.MultimodalConfig(**SIZES, video_freeze=False)
    jmodel = jtm.build_model(cfg, MODALITIES)
    b = labelled()
    example = {m: {k: np.zeros_like(v) for k, v in d.items()}
               for m, d in batch(1).items()}
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example), seed=5)
    specs = {"phys": JaxLossSpec("focal", class_weights=ALPHA, gamma=2.0),
             "verb": JaxLossSpec("ce")}

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           b["modalities"], train=False)
        return _head_losses_and_metrics(out, b, specs, 2)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return variables, b, float(loss), jax.tree.map(np.asarray, grads)


def port_model(variables):
    cfg = ttm.MultimodalConfig(**SIZES, video_freeze=False)
    return load_jax_variables(ttm.build_model(cfg, MODALITIES), variables)


SPECS = {"phys": LossSpec("focal", class_weights=ALPHA, gamma=2.0),
         "verb": LossSpec("ce")}


def test_loss_and_every_gradient_match_jax(reference):
    variables, b, want_loss, grads = reference
    model = port_model(variables).eval()
    tb = torch_tree(b)
    total, metrics = head_losses_and_metrics(model(tb["modalities"]), tb,
                                             SPECS, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), want_loss, atol=1e-5, rtol=1e-5)
    assert sorted(metrics) == ["phys", "verb"]
    assert metrics["verb"]["valid"].item() == 2.0
    want = from_jax_variables({"params": grads})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


def test_one_adam_step_matches_optax(reference):
    variables, _, _, grads = reference
    params = {k: v for k, v in from_jax_variables(variables).items()
              if not k.endswith(("running_mean", "running_var"))}
    g = from_jax_variables({"params": grads})
    tx = optax.adam(LR)

    @jax.jit
    def step(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    want = from_jax_variables({"params": jax.tree.map(
        np.asarray, step(grads, variables["params"]))})
    tensors = {k: v.clone().requires_grad_() for k, v in params.items()}
    for k, t in tensors.items():
        t.grad = g[k].clone()
    adam(list(tensors.values()), LR).step()
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_train_step_lowers_the_loss_and_moves_bn_statistics(reference):
    variables, b, _, _ = reference
    state = create_train_state(port_model(variables),
                               OptimizerConfig(learning_rate=1e-4), "cpu")
    bn = state.model.extractors["audio"].extractor.bn0
    mean0 = bn.running_mean.clone()
    tb = torch_tree(b)
    losses = []
    for _ in range(2):  # the same dropout draws both times
        set_generator(state.model, torch.Generator().manual_seed(3))
        losses.append(train_step(state, tb, SPECS, 2)["total_loss"].item())
    assert state.step == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    assert not torch.equal(bn.running_mean, mean0)
