"""Port train-mode modules: BatchNorm1d with batch statistics against the
JAX package's, and the stochastic modules (Dropout, Dropout1d,
SampleDropout, StochasticDepth).

BatchNorm: the same input and affine go through JAX's
`BatchNorm1d(use_running_average=False)` with a mutable `batch_stats` and
the port's module in train mode; output, new running statistics and the
gradients of a weighted sum are held at 1e-5 (f32, summation order only).
The random modules cannot share JAX's bits, so they are checked by their
rule: the identity in eval mode and at rate 0, and in train mode every row
(or channel, or element) either 0 or x / keep, the same generator seed
giving the same mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models.nn1d import (
    BatchNorm1d as JaxBatchNorm1d)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.nn1d import (
    BatchNorm1d, Dropout1d, SampleDropout)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    Dropout, set_generator)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    StochasticDepth)


def test_batchnorm_train_mode_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 11, 16)) * 2 + 0.5).astype(np.float32)
    weights = rng.standard_normal((3, 11, 16)).astype(np.float32)
    jm = JaxBatchNorm1d()
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    variables["params"]["bias"] = rng.normal(0, 0.2, 16).astype(np.float32)
    variables["batch_stats"]["mean"] = rng.normal(0, 0.1, 16).astype(
        np.float32)
    variables["batch_stats"]["var"] = rng.uniform(0.5, 1.5, 16).astype(
        np.float32)

    def loss(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * weights), (y, upd)

    (_, (want_y, upd)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    port = load_jax_variables(BatchNorm1d(16), variables).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(weights)).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **tol)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **tol)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(g_params["scale"]), **tol)
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(g_params["bias"]), **tol)


# (module, input shape, the axes a mask is shared over)
STOCHASTIC = {
    "dropout": (lambda r: Dropout(r), (4, 6, 8), ()),
    "dropout1d": (lambda r: Dropout1d(r), (4, 6, 8), (1,)),
    "sample_dropout": (lambda r: SampleDropout(r), (6, 8), (1,)),
    "stochastic_depth": (lambda r: StochasticDepth(r), (5, 2, 3, 3, 4),
                         (1, 2, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(STOCHASTIC))
def test_stochastic_module_rule(name):
    make, shape, shared = STOCHASTIC[name]
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)) + 0.5
    assert make(0.3).eval()(x) is x
    assert make(0.0).train()(x) is x

    def draw(seed):
        return set_generator(make(0.25).train(),
                             torch.Generator().manual_seed(seed))(x)

    y = draw(1)
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.75)[kept], rtol=0, atol=0)
    assert 0 < kept.sum() < kept.numel()
    if shared:  # the mask is constant over the shared axes
        assert torch.equal(kept, kept.all(dim=shared, keepdim=True)
                           .expand_as(kept))
    assert torch.equal(draw(1), y)
    assert not all(torch.equal(draw(s), y) for s in range(2, 6))
