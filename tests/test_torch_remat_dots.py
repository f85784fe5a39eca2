"""Remat policy "dots" (models/stochastic.checkpoint's selective
checkpoint: the 2-D products' outputs saved, the rest recomputed) against
the JAX package's `dots_with_no_batch_dims_saveable`.

- On tests/test_remat_extractor.py's Swin (embed 8, depths (2, 2), heads
  (2, 4), window (4, 3, 3), input (2, 8, 24, 24, 3)) with random bias
  tables and LayerNorms: the output under "dots" against JAX's "dots" at
  that test's rtol 2e-5, atol 2e-6, and every gradient of sum(out ** 2) at
  rtol 2e-5 with the atol 2e-6 scaled by the tensor's largest gradient
  (JAX's atol holds two XLA programs of one package; the gradients here
  run to ~80).  The LayerNorms are random because at their init (weight
  1, bias 0) sum(out ** 2) hardly depends on the input: the patch
  embedding's gradient is then a cancellation that f32 rounding moves by
  ~2e-3 of its largest in JAX itself against float64.  Against the port's
  save-nothing remat and no remat: output and gradients bit for bit.
- In train mode with stochastic depth drawing (rate 0.9) from an explicit
  generator, each StochasticDepth draws the same rows in the recompute as
  in the forward, and the values and gradients equal remat's and no
  remat's.
- The products are saved: in the backward "dots" runs no `addmm` (the
  Linear layers' forward products) where "none" recomputes them; both run
  the window-attention (with its row logsumexp) and roll ops again.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multimodalaggressionrecognition_tpu.models.swin3d import (
    SwinTransformer3d as JaxSwin)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    checkpoint, set_generator)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    StochasticDepth, SwinTransformer3d)

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 4), window=(4, 3, 3))


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 8, 24, 24, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_dots():
    """(numpy variables with random bias tables, JAX "dots" output and
    gradients of sum(out ** 2))."""
    x = _x()
    dots = JaxSwin(**SMALL, remat=True, remat_policy="dots")
    variables = jax.tree.map(np.asarray, jax.jit(dots.init)(
        jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(1)

    def draw(path, v):
        leaf, module = path[-1].key, path[-2].key
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if leaf == "relative_position_bias_table":
            return noise * 0.5
        if leaf == "scale":
            return 1.0 + 0.1 * noise
        if leaf == "bias" and "norm" in module:
            return 0.05 * noise
        return v

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    out = np.asarray(jax.jit(dots.apply)(variables, x))
    grads = jax.jit(jax.grad(
        lambda v: jnp.sum(dots.apply(v, x) ** 2)))(variables)
    return variables, out, jax.tree.map(np.asarray, grads)


def _port_run(variables, x, train=False, seed=None, **kw):
    model = load_jax_variables(SwinTransformer3d(**SMALL, **kw), variables)
    model.train()  # remat runs in train mode only
    if not train:  # ... with stochastic depth off: eval-mode values
        for m in model.modules():
            if isinstance(m, StochasticDepth):
                m.rate = 0.0
    if seed is not None:
        set_generator(model, torch.Generator().manual_seed(seed))
    out = model(torch.from_numpy(x))
    torch.sum(out ** 2).backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_dots_matches_jax_dots(jax_dots):
    variables, want_out, want_grads = jax_dots
    out, grads = _port_run(variables, _x(), remat=True, remat_policy="dots")
    np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-5, atol=2e-6)
    want = from_jax_variables(want_grads)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-5,
                                   atol=2e-6 * scale, err_msg=name)
    for kw in (dict(remat=True, remat_policy="none"), dict(remat=False)):
        out0, grads0 = _port_run(variables, _x(), **kw)
        assert torch.equal(out0, out)
        assert sorted(grads0) == sorted(grads)
        for name, g in grads0.items():
            assert torch.equal(g, grads[name]), (kw, name)


def _draw_states(model):
    """{module name: [generator state before each draw]} of the drawing
    StochasticDepth modules: equal states draw equal masks."""
    states = collections.defaultdict(list)
    for name, m in model.named_modules():
        if isinstance(m, StochasticDepth) and m.rate > 0:
            def noise_shape(x, name=name, m=m, shape=m.noise_shape):
                states[name].append(m.generator.get_state())
                return shape(x)
            m.noise_shape = noise_shape
    return states


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_recompute_draws_the_forward_masks(jax_dots, policy):
    variables = jax_dots[0]
    model = load_jax_variables(
        SwinTransformer3d(**SMALL, stochastic_depth_prob=0.9, remat=True,
                          remat_policy=policy), variables).train()
    set_generator(model, torch.Generator().manual_seed(5))
    states = _draw_states(model)
    out = model(torch.from_numpy(_x(2)))
    torch.sum(out ** 2).backward()
    assert len(states) == 6  # every block but the first draws twice
    for name, drawn in states.items():
        assert len(drawn) == 2, name  # the forward and its recompute
        assert torch.equal(drawn[0], drawn[1]), name
    grads = {n: p.grad for n, p in model.named_parameters()}
    plain_out, plain_grads = _port_run(
        variables, _x(2), train=True, seed=5, stochastic_depth_prob=0.9)
    assert torch.equal(out.detach(), plain_out)
    assert not torch.allclose(plain_out, _port_run(variables, _x(2))[0])
    for name, g in plain_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_products_and_recomputes_the_kernels(jax_dots):
    backward = {}
    for policy in ("dots", "none"):
        model = load_jax_variables(
            SwinTransformer3d(**SMALL, remat=True, remat_policy=policy),
            jax_dots[0]).train()
        out = model(torch.from_numpy(_x()))
        with _Ops() as ops:
            torch.sum(out ** 2).backward()
        backward[policy] = ops.counts
    # the recompute stops once it has what the backward needs, so "none"
    # recomputes most of the 16 Linear products (qkv, proj, fc1, fc2 in 4
    # blocks), "dots" none of them
    assert backward["none"]["aten.addmm.default"] >= 12
    assert backward["dots"]["aten.addmm.default"] == 0
    for op in ("mar_torch.window_attention_lse.default",
               "mar_torch.roll.default"):
        assert backward["dots"][op] == backward["none"][op] > 0, op
    with pytest.raises(ValueError, match="remat policy"):
        checkpoint(model.stage0_block0, out.detach(), policy="dot")
