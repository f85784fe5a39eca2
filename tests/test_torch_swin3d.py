"""Port Swin3D (models/swin3d.py and its helpers) against the JAX package.

Same weights (JAX init, carried by io/from_jax.py) and the same inputs made
with numpy.  The window-attention module is held at 1e-5 (as
tests/test_pallas.py holds its Pallas route), shifted, unshifted and with a
clamped window; the small clamped SwinTransformer3d of
tests/test_swin_s3d_parity.py at 1e-4, as there; the GELU modes within
2e-6 of JAX's (the polynomial GELU is within 1.3e-6 of the exact one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import swin3d as js
from multimodalaggressionrecognition_tpu.ops.erf import gelu_exact
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import swin3d as ts
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.ops.erf import gelu
from multimodalaggressionrecognition_tpu_torch.ops.video import (
    unwindow_features, window_frames)


def _init(jm, x, seed=0):
    """JAX variables as numpy, with random (non-zero) bias tables."""
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                      if p[-1].key == "relative_position_bias_table" else v),
        variables)


def _run(port, x):
    with torch.inference_mode():
        return port.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("window", [(8, 7, 7), (4, 3, 3), (2, 2, 2)])
def test_relative_position_index_equals_jax(window):
    np.testing.assert_array_equal(ts._relative_position_index(window),
                                  js._relative_position_index(window))


@pytest.mark.parametrize("padded,window,shift", [
    ((4, 28, 28), (4, 7, 7), (0, 3, 3)), ((4, 14, 14), (4, 7, 7), (0, 3, 3)),
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)), ((4, 6, 14), (4, 6, 7), (0, 0, 3)),
    ((4, 7, 7), (4, 7, 7), (0, 0, 0))])
def test_attention_mask_equals_jax(padded, window, shift):
    got = ts._attention_mask(*padded, window, shift)
    want = js._attention_mask(*padded, window, shift)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and set(np.unique(got)) <= {0.0, -100.0}
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["unshifted", "shifted", "clamped"])
def test_window_attention_module_matches_jax(case):
    """`clamped`: the (8,7,7) window on a (4, 6, 9) input clamps t and h
    (no shift there), pads w to 14 and shifts it by 3; the bias index is
    the full window's, sliced."""
    dim, heads, window, shift, shape = {
        "unshifted": (24, 3, (4, 4, 4), (0, 0, 0), (2, 4, 8, 8)),
        "shifted": (24, 3, (4, 4, 4), (2, 2, 2), (2, 4, 8, 8)),
        "clamped": (32, 2, (8, 7, 7), (4, 3, 3), (1, 4, 6, 9)),
    }[case]
    x = np.random.default_rng(5).standard_normal(shape + (dim,)).astype(
        np.float32)
    jm = js.ShiftedWindowAttention3d(dim, heads, window=window, shift=shift)
    variables = _init(jm, x)
    want = jm.apply(variables, x)
    port = load_jax_variables(
        ts.ShiftedWindowAttention3d(dim, heads, window, shift), variables)
    np.testing.assert_allclose(_run(port, x), np.asarray(want), atol=1e-5)


def test_patch_merging_with_odd_h_and_w_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 7, 8)).astype(
        np.float32)
    jm = js.PatchMerging3d(8)
    variables = _init(jm, x)
    port = load_jax_variables(ts.PatchMerging3d(8), variables)
    got = _run(port, x)
    assert got.shape == (2, 3, 3, 4, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)),
                               atol=1e-5)


def test_small_clamped_swin_transformer_matches_jax():
    """tests/test_swin_s3d_parity.py's small config: embed 8, depths (2,2),
    heads (2,4), window (4,3,3); the window clamps in t and at stage 1 in
    h and w."""
    kw = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 4), window=(4, 3, 3))
    x = np.random.default_rng(7).standard_normal((2, 4, 24, 24, 3)).astype(
        np.float32)
    jm = js.SwinTransformer3d(**kw)
    variables = _init(jm, x, seed=1)
    want = np.asarray(jnp.mean(jax.jit(jm.apply)(variables, x),
                               axis=(1, 2, 3)))
    port = load_jax_variables(ts.SwinTransformer3d(**kw), variables)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).mean(dim=(1, 2, 3)).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gelu_modes_match_jax():
    x = np.linspace(-8.0, 8.0, 40001, dtype=np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(gelu(xt, "poly").numpy(),
                               np.asarray(gelu_exact(jnp.asarray(x))),
                               atol=2e-6)
    np.testing.assert_allclose(
        gelu(xt, "erf").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)), atol=2e-6)
    np.testing.assert_allclose(
        gelu(xt, "tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)), atol=2e-6)
    with pytest.raises(ValueError, match="gelu must be"):
        gelu(xt, "exact")


def test_window_frames_drops_trailing_frames():
    x = torch.arange(2 * 19 * 2).reshape(2, 19, 1, 1, 2)
    wins, num = window_frames(x, 8)
    assert num == 2 and wins.shape == (4, 8, 1, 1, 2)
    assert torch.equal(wins[2], x[1, :8]) and torch.equal(wins[3], x[1, 8:16])
    feats = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(unwindow_features(feats, 2, 2)[1], feats[2:])


def test_train_mode_raises_until_fine_tuning():
    """Fine-tuning is ported: a block in train mode runs its stochastic
    depth from its generator (reproducible per seed; at rate 0 it is the
    eval-mode block), and gradients reach the bias table.  What still
    raises is the remat policy that is not ported."""
    x = torch.randn((2, 2, 4, 4, 8),
                    generator=torch.Generator().manual_seed(0))
    block = ts.SwinBlock3d(8, 2, (2, 2, 2), sd_prob=0.5)

    def run(seed):
        return set_generator(block.train(),
                             torch.Generator().manual_seed(seed))(x)

    y = run(1)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert torch.equal(run(1), y)
    y.sum().backward()
    assert block.attn.relative_position_bias_table.grad.abs().max() > 0
    for sd in (block.sd1, block.sd2):
        sd.rate = 0.0
    with torch.no_grad():
        torch.testing.assert_close(block.train()(x), block.eval()(x))
    with pytest.raises(NotImplementedError, match="dots"):
        ts.SwinTransformer3d(embed_dim=8, depths=(2,), num_heads=(2,),
                             remat=True, remat_policy="dots")
