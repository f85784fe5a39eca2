"""The port's S3D (models/s3d.py) against the JAX package's, on the same
weights carried by io/from_jax.py (strict load): `S3DExtractor` features
at (1, 16, 64, 64) within 1e-4 of the largest (tests/test_swin_s3d_parity.py
holds the JAX one to torchvision's at 2e-3), in eval mode with random
BatchNorm statistics (eps 1e-3); one `SepInceptionBlock3D` in train mode
within 1e-5, its batch statistics as flax moves them; the classifier's
pooled conv head on a feature map that reaches (2, 7, 7)."""

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import s3d as js3d
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import s3d
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_s3d_extractor_features_match_jax():
    x = (np.random.default_rng(0).standard_normal((1, 16, 64, 64, 3))
         * 0.5).astype(np.float32)
    jm = js3d.S3DExtractor()
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                x), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    model = load_jax_variables(s3d.S3DExtractor(), variables).eval()
    assert all(m.bn.eps == 1e-3 for m in model.modules()
               if isinstance(m, s3d.ConvBN))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 1024) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_inception_block_train_mode_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 9, 9, 12)).astype(
        np.float32)
    spec = (8, 6, 10, 4, 6, 5)
    jm = js3d.SepInceptionBlock3D(*spec)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                x), seed=3)
    want, updated = jm.apply(variables, x, train=True,
                             mutable=["batch_stats"])
    block = load_jax_variables(s3d.SepInceptionBlock3D(12, *spec),
                               variables).train()
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    stats = from_jax_variables({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, updated["batch_stats"])})
    buffers = dict(block.named_buffers())
    assert sorted(buffers) == sorted(stats)
    for name, ref in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=name)


def test_s3d_classifier_head_matches_jax():
    """The head alone (avg pool (2, 7, 7) at stride 1, 1x1x1 conv, mean)
    over a feature map of that size: the backbone is the extractor's."""
    h = np.random.default_rng(4).standard_normal((2, 3, 8, 7, 1024)).astype(
        np.float32)
    head = random_variables(jax.eval_shape(
        js3d.Conv3d(5, 1).init, jax.random.PRNGKey(0), h), seed=5)
    pooled = np.asarray(jax.lax.reduce_window(
        h, 0.0, jax.lax.add, (1, 2, 7, 7, 1), (1, 1, 1, 1, 1), "VALID")
        / 98.0)
    want = np.asarray(js3d.Conv3d(5, 1).apply(head, pooled)).mean(
        axis=(1, 2, 3))
    model = s3d.S3DClassifier(5).eval()
    model.head.load_state_dict(from_jax_variables(head))
    model.features = torch.nn.Identity()
    with torch.no_grad():
        # the classifier permutes its input to (B, C, T, H, W) itself
        got = model(torch.from_numpy(h)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
