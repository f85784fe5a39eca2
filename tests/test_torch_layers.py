"""Port transformer layers (models/layers.py) against the JAX package's.

Same weights (JAX init, carried by io/from_jax.py) and the same inputs, with
a key-padding mask that masks one row completely: both sides give zero
attention there (safe softmax), and the encoder zeroes masked rows in eval
mode.  Tolerance 1e-5, as tests/test_layers.py holds the JAX layers to
torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import layers as jl
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import layers as tl

E, H = 32, 4


def _inputs(seed=0, b=3, t=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, E)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[0, 5:] = True   # zero-padded tail
    mask[1, :] = True    # every key masked: a padded serving row
    return x, mask


def _np_vars(variables):
    return jax.tree.map(np.asarray, variables)


def test_mhsa_matches_jax():
    x, mask = _inputs()
    jm = jl.MultiheadSelfAttention(E, H)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # non-zero biases so every parameter is exercised
    variables = jax.tree.map(
        lambda v: v + 0.01 * np.arange(v.size, dtype=np.float32).reshape(
            v.shape) / v.size, _np_vars(variables))
    want = jm.apply(variables, jnp.asarray(x),
                    key_padding_mask=jnp.asarray(mask))
    port = load_jax_variables(tl.MultiheadSelfAttention(E, H), variables)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_encoder_matches_jax_and_zeroes_masked_rows(num_layers):
    x, mask = _inputs(seed=num_layers, t=11)
    jm = jl.TransformerEncoder(d_model=E, nhead=H, num_layers=num_layers,
                               dim_feedforward=64)
    variables = _np_vars(jm.init(jax.random.PRNGKey(num_layers),
                                 jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x),
                    key_padding_mask=jnp.asarray(mask))
    port = tl.TransformerEncoder(E, H, num_layers, dim_feedforward=64)
    load_jax_variables(port, variables)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert (got[mask] == 0).all() and np.abs(got[~mask]).sum(-1).min() > 0


def test_seeded_init_is_deterministic():
    a = tl.seeded_init_(tl.TransformerEncoder(E, H, 1, 64), seed=3)
    b = tl.seeded_init_(tl.TransformerEncoder(E, H, 1, 64), seed=3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sa = a.layers[0].self_attn
    assert sa.in_proj_bias.abs().sum() == 0 and sa.out_proj.bias.abs().sum() == 0
    assert sa.in_proj_weight.abs().max() <= (6.0 / (E + 3 * E)) ** 0.5
