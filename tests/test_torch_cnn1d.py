"""Port CNN1D tower (models/nn1d.py, models/cnn1d.py) against the JAX one.

JAX weights with non-trivial BatchNorm statistics are carried by
io/from_jax.py; the port folds each BatchNorm into its conv's epilogue (the
stem's into the framed-conv kernel).  Tolerance 2e-3, as
tests/test_pallas.py holds the JAX Pallas stem to the XLA one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import cnn1d as jc
from multimodalaggressionrecognition_tpu.models.nn1d import (
    BatchNorm1d as JaxBatchNorm1d)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import cnn1d as tc
from multimodalaggressionrecognition_tpu_torch.models.nn1d import (
    BatchNorm1d, max_pool1d)


def randomize_norms(variables, seed=0):
    """numpy copy of a JAX variables tree with non-trivial BatchNorm
    statistics and norm affines (fresh inits are the identity)."""
    rng = np.random.default_rng(seed)

    def fill(path, v):
        v = np.asarray(v, np.float32)
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(fill, variables)


def _wave(seed, b=2, length=20000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, length)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", ["extractor", "wrapper", "classifier"])
def test_cnn1d_matches_jax(name):
    jax_mod, port_mod = {
        "extractor": (jc.CNN1DExtractor(), tc.CNN1DExtractor()),
        "wrapper": (jc.AudioCnn1DExtractorWrapper(96),
                    tc.AudioCnn1DExtractorWrapper(96)),
        "classifier": (jc.CNN1D(class_num=3), tc.CNN1D(class_num=3)),
    }[name]
    x = _wave(len(name))
    variables = randomize_norms(jax.jit(jax_mod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x)), seed=len(name))
    want = np.asarray(jax.jit(jax_mod.apply)(variables, jnp.asarray(x)))
    load_jax_variables(port_mod, variables)
    with torch.inference_mode():
        got = port_mod.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_batchnorm_eval_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    jm = JaxBatchNorm1d()
    variables = randomize_norms(jm.init(jax.random.PRNGKey(0), x), seed=3)
    variables["params"]["bias"] = rng.normal(0, 0.2, 16).astype(np.float32)
    want = np.asarray(jm.apply(variables, x))
    port = load_jax_variables(BatchNorm1d(16), variables).eval()
    with torch.inference_mode():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-5)
        scale, shift = port.folded_scale_shift()
        np.testing.assert_allclose((torch.from_numpy(x) * scale + shift)
                                   .numpy(), want, atol=1e-5)


def test_max_pool_floors_and_training_mode_raises():
    """Train mode: BatchNorm with batch statistics after each conv (the
    stem through the framed-conv autograd Function), against JAX's
    `train=True` with dropout 0, at 2e-3; only the eval mode folds, so
    folding a training BatchNorm raises."""
    assert max_pool1d(torch.zeros(1, 2001, 3), 4).shape == (1, 500, 3)
    x = _wave(9)
    jm = jc.CNN1DExtractor(dropout=0.0)
    variables = randomize_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)), seed=9)
    want, upd = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port = load_jax_variables(tc.CNN1DExtractor(dropout=0.0), variables)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-3)
    np.testing.assert_allclose(port.bn8.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn8"]["var"]),
                               rtol=1e-4)
    with pytest.raises(RuntimeError, match="only the eval mode folds"):
        port.bn0.folded_scale_shift()
