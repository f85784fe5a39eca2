"""The port's trainable Swin tower against the JAX package's
(tests/test_swin_trainable.py, on the same TinySwin: embed 16, depths (2,),
heads (2,), window (8, 7, 7), input (1, 16, 28, 28, 3) in 8-frame windows).

Unfrozen, every parameter gets a non-zero gradient, equal to JAX's at the
JAX test's rtol/atol 1e-5 (same weights through io/from_jax.py, random
bias tables, eval mode, loss sum(out ** 2)); frozen, none does.  Remat
(per-block and around the whole backbone) changes neither the values nor
the gradients in train mode with stochastic depth drawing, and an unknown
remat policy raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodalaggressionrecognition_tpu.models.swin3d import (
    SwinTransformer3d as JaxSwin)
from multimodalaggressionrecognition_tpu.models.video_extractors import (
    WindowedVideoExtractor as JaxWindowed)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    SwinTransformer3d)
from multimodalaggressionrecognition_tpu_torch.models.video_extractors import (
    WindowedVideoExtractor)

TINY = dict(embed_dim=16, depths=(2,), num_heads=(2,), window=(8, 7, 7))


class JaxTinySwin(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = JaxSwin(**TINY, name="backbone")(x, train=train)
        return jnp.mean(h, axis=(1, 2, 3))


class TinySwin(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.backbone = SwinTransformer3d(**TINY, **kw)

    def forward(self, x):
        return self.backbone(x).mean(dim=(1, 2, 3))


def _x(shape=(1, 16, 28, 28, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_pair():
    """(numpy variables with random bias tables, JAX grads of sum(out**2))."""
    x = _x()
    model = JaxWindowed(JaxTinySwin(), window=8, freeze=False)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                      if p[-1].key == "relative_position_bias_table" else v),
        variables)
    grads = jax.jit(jax.grad(
        lambda v: jnp.sum(model.apply(v, x) ** 2)))(variables)
    return variables, grads


def _port(variables, freeze=False, **kw):
    return load_jax_variables(
        WindowedVideoExtractor(TinySwin(**kw), window=8, freeze=freeze),
        variables)


def test_unfrozen_gradients_flow_and_match_jax(jax_pair):
    variables, grads = jax_pair
    port = _port(variables).eval()
    torch.sum(port(torch.from_numpy(_x())) ** 2).backward()
    want = load_jax_variables(_port(variables), grads).state_dict()
    named = dict(port.named_parameters())
    assert len(named) == len(jax.tree.leaves(grads["params"]))
    for name, p in named.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_frozen_backbone_gets_no_gradient_and_stays_in_eval(jax_pair):
    port = _port(jax_pair[0], freeze=True).train()
    assert not port.backbone.training
    out = port(torch.from_numpy(_x()))
    assert not out.requires_grad  # nothing to differentiate
    assert not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("where", ["blocks", "backbone"])
def test_remat_changes_nothing_in_train_mode(jax_pair, where):
    """Stochastic depth at rate 0.9 in the second block draws from the
    generator: the recompute must draw the same rows."""
    variables = jax_pair[0]
    x = torch.from_numpy(_x((2, 16, 14, 14, 3), seed=3))

    def run(remat):
        model = WindowedVideoExtractor(
            TinySwin(stochastic_depth_prob=0.9,
                     remat=remat and where == "blocks"),
            window=8, freeze=False, remat=remat and where == "backbone")
        load_jax_variables(model, variables).train()
        set_generator(model, torch.Generator().manual_seed(5))
        out = model(x)
        torch.sum(out ** 2).backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()}

    out0, g0 = run(False)
    out1, g1 = run(True)
    with torch.no_grad():
        evaluated = _port(variables).eval()(x)
    assert not torch.allclose(out0, evaluated)  # some rows were dropped
    torch.testing.assert_close(out1, out0, rtol=0, atol=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-5)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        SwinTransformer3d(**TINY, remat=True, remat_policy="dots_saveable")
    with pytest.raises(NotImplementedError, match="dots"):
        SwinTransformer3d(**TINY, remat=True, remat_policy="dots")
    SwinTransformer3d(**TINY, remat=True, remat_policy="none")
