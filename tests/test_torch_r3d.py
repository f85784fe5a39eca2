"""The port's 3-D conv blocks and R3D-18 models (models/nn3d.py,
models/r3d.py) against the JAX package's, on the same weights carried by
io/from_jax.py (strict load).

- nn3d: `Conv3d` with stride, symmetric padding and no bias (both layouts)
  within 1e-5; `BatchNorm3d` in train mode (batch statistics, the running
  ones moved with momentum 0.1 and the unbiased variance) and eval mode
  within 1e-5, its eps per instance; `max_pool3d` with -inf padding and
  floor, bit for bit; `global_avg_pool` within 1e-6.
- `_resize_nearest_3d` bit for bit at divisible (strided slice) and
  non-divisible (index gather) sizes.
- `R3D18Classifier` logits at (1, 8, 56, 56) within 1e-4 of the largest
  logit (the JAX default runs its stem through the space-to-depth
  rewrite, which its own tests hold to the plain conv within 1e-5).
- `R3DWithBboxes` with a mask at (2, 8, 32, 32) in train mode (dropout 0,
  so both sides are deterministic): logits within 1e-4 of the largest and
  the BatchNorm running statistics as flax updates them within 1e-5,
  against the JAX default (f32, space-to-depth stem, jitted); every
  gradient within 1e-4 of its tensor's largest of `jax.grad` taken in
  float64 (`jax.enable_x64`; JAX's BatchNorm still normalizes in f32, as
  the port's f32 run does: the two agree within ~2e-5).  JAX's f32
  gradient is no reference at this shape: it depends on how XLA
  evaluates it (jitted with the space-to-depth stem it is 3.5e-2 of the
  largest off at layer1_0.conv2, 2.5e-2 at layer1_0.bn2.bias), and a
  float64 BatchNorm moves stem.bn.bias's and stem.conv.weight's by ~9e-4.
- The bridge takes a 5-D kernel named conv{i} as a Conv3d (R3D's blocks)
  and a 2-D one as the CNN1D's Conv1d chain, in one tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import nn3d as jnn3d
from multimodalaggressionrecognition_tpu.models import r3d as jr3d
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import nn3d, r3d
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _ndhwc(t):
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


# (features, kernel, stride, padding, bias): R3D's stem, block conv,
# downsample and S3D's separable convs
CONVS = [(8, (3, 7, 7), (1, 2, 2), (1, 3, 3), False),
         (6, 3, 2, 1, False), (6, 1, 2, 0, False),
         (5, (1, 3, 3), (1, 2, 2), (0, 1, 1), False),
         (5, (3, 1, 1), 1, (1, 0, 0), True)]


@pytest.mark.parametrize("feats,kernel,stride,padding,bias", CONVS)
@pytest.mark.parametrize("channels_first", [False, True])
def test_conv3d_matches_jax(feats, kernel, stride, padding, bias,
                            channels_first):
    x = np.random.default_rng(0).standard_normal((2, 6, 13, 12, 3)).astype(
        np.float32)
    jm = jnn3d.Conv3d(feats, kernel, stride=stride, padding=padding,
                      use_bias=bias)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                x), seed=1)
    want = np.asarray(jm.apply(variables, x))
    module = nn3d.Conv3d(3, feats, kernel, stride=stride, padding=padding,
                         bias=bias, channels_first=channels_first)
    load_jax_variables(module, variables)
    with torch.no_grad():
        got = (_ndhwc(module(_ncdhw(x))) if channels_first
               else module(torch.from_numpy(x)).numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm3d_matches_jax(train, eps):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    jm = jnn3d.BatchNorm(eps=eps)
    variables = random_variables(jax.eval_shape(
        lambda k, v: jm.init(k, v, use_running_average=True),
        jax.random.PRNGKey(0), x), seed=3)
    want, updated = jm.apply(variables, x, use_running_average=not train,
                             mutable=["batch_stats"])
    module = load_jax_variables(nn3d.BatchNorm3d(6, eps=eps), variables)
    module.train(train)
    with torch.no_grad():
        got = _ndhwc(module(_ncdhw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(module.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(module.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)


# (window, stride, padding): S3D's spatial, inception-branch, "pool" and
# "pool2" pools, on odd sizes so the floor shows
POOLS = [((1, 3, 3), (1, 2, 2), (0, 1, 1)), (3, 1, 1), (3, 2, 1), (2, 2, 0)]


@pytest.mark.parametrize("window,stride,padding", POOLS)
def test_max_pool3d_matches_jax(window, stride, padding):
    x = np.random.default_rng(4).standard_normal((2, 7, 9, 11, 3)).astype(
        np.float32)
    want = np.asarray(jnn3d.max_pool_nd(jnp.asarray(x), window, stride,
                                        padding))
    got = _ndhwc(nn3d.max_pool3d(_ncdhw(x), window, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 7, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        nn3d.global_avg_pool(_ncdhw(x)).numpy(),
        np.asarray(jnn3d.global_avg_pool(jnp.asarray(x))), atol=1e-6)


# (T, H, W) in -> out: the R3D pyramid's exact halvings, a non-divisible
# shrink on every axis, and one axis kept
RESIZES = [((16, 112, 112), (8, 56, 56)), ((8, 56, 56), (4, 28, 28)),
           ((9, 30, 17), (4, 7, 5)), ((5, 32, 31), (5, 16, 7))]


@pytest.mark.parametrize("size,out", RESIZES)
def test_resize_nearest_3d_matches_jax_bit_for_bit(size, out):
    m = (np.random.default_rng(6).random((2, *size, 1)) > 0.5).astype(
        np.float32)
    m[0, :, 3:9, 2:11] = 1.0
    want = np.asarray(jr3d._resize_nearest_3d(jnp.asarray(m), *out))
    got = _ndhwc(r3d._resize_nearest_3d(_ncdhw(m), *out))
    assert got.shape == want.shape == (2, *out, 1)
    np.testing.assert_array_equal(got, want)


def test_r3d18_classifier_logits_match_jax():
    x = (np.random.default_rng(7).standard_normal((1, 8, 56, 56, 3))
         * 0.5).astype(np.float32)
    jm = jr3d.R3D18Classifier(10)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                x), seed=8)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    model = load_jax_variables(r3d.R3D18Classifier(10), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _bbox_clip(seed, n=2, t=8, hw=32):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (n, t, hw, hw, 3)).astype(np.float32)
    mask = np.zeros((n, t, hw, hw, 1), np.float32)
    mask[0, :, 4:20, 6:25] = 1.0
    mask[1, 2:, 10:31, 0:13] = 1.0
    return frames, mask


def _probe_loss_and_grads(jm, variables, frames, mask, probe, dtype):
    """jax.grad of sum(logits * probe) in train mode, at `dtype`: (logits,
    grads, updated batch_stats)."""
    cast = functools.partial(jax.tree.map, lambda a: np.asarray(a, dtype))
    variables, frames, mask, probe = cast((variables, frames, mask, probe))

    def loss_fn(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               frames, mask, train=True,
                               mutable=["batch_stats"])
        return jnp.sum(logits * probe), (logits, upd["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return jax.tree.map(np.asarray, (logits, grads, stats))


def _port_probe_grads(variables, frames, mask, probe):
    model = load_jax_variables(r3d.R3DWithBboxes(4, alpha=0.4, dropout=0.0),
                               variables).train()
    logits = model(torch.from_numpy(frames), torch.from_numpy(mask))
    (logits * torch.from_numpy(probe)).sum().backward()
    return model, logits.detach()


def test_r3d_with_bboxes_train_step_matches_jax():
    frames, mask = _bbox_clip(9)
    jm = jr3d.R3DWithBboxes(class_num=4, alpha=0.4, dropout=0.0)
    variables = random_variables(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), frames, mask), seed=10)
    probe = np.random.default_rng(11).standard_normal((2, 4)).astype(
        np.float32)
    want_logits, _, want_stats = _probe_loss_and_grads(
        jm, variables, frames, mask, probe, np.float32)
    with jax.enable_x64(True):
        _, grads64, _ = _probe_loss_and_grads(jm, variables, frames, mask,
                                              probe, np.float64)
    model, logits = _port_probe_grads(variables, frames, mask, probe)
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=1e-4 * np.abs(want_logits).max())
    want = from_jax_variables({"params": grads64})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    stats = from_jax_variables({"params": {}, "batch_stats": want_stats})
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(stats)
    for name, ref in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=name)


def test_r3d_with_bboxes_eval_logits_match_jax_and_r3d_drops_the_mask():
    frames, mask = _bbox_clip(12, t=6, hw=24)
    jm = jr3d.R3DWithBboxes(class_num=2)
    variables = random_variables(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), frames, mask), seed=13)
    model = load_jax_variables(r3d.R3DWithBboxes(2), variables).eval()
    plain = load_jax_variables(r3d.R3D(2), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(frames), torch.from_numpy(mask)).numpy()
        no_mask = model(torch.from_numpy(frames)).numpy()
        dropped = plain(torch.from_numpy(frames),
                        torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(jm.apply)(variables, frames, mask))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(dropped, no_mask)
    assert np.abs(got - no_mask).max() > 1e-3  # the mask moves the logits


def test_r3d_dropout_draws_from_its_generator():
    frames, mask = _bbox_clip(14, n=4, t=4, hw=16)
    model = r3d.R3DWithBboxes(2).train()
    out = []
    for _ in range(2):
        set_generator(model, torch.Generator().manual_seed(3))
        out.append(model(torch.from_numpy(frames),
                         torch.from_numpy(mask)).detach())
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    set_generator(model, torch.Generator().manual_seed(4))
    other = model(torch.from_numpy(frames), torch.from_numpy(mask)).detach()
    assert not torch.equal(out[0], other)


def test_bridge_takes_r3d_conv1_as_conv3d_beside_a_cnn1d_chain():
    rng = np.random.default_rng(15)
    conv0 = rng.standard_normal((10, 8)).astype(np.float32)     # K 10, C_in 1
    conv1 = rng.standard_normal((3 * 8, 16)).astype(np.float32)  # K 3, C_in 8
    block = rng.standard_normal((3, 3, 3, 4, 5)).astype(np.float32)
    down = rng.standard_normal((1, 1, 1, 4, 5)).astype(np.float32)
    tree = {"params": {
        "cnn": {"conv0": {"kernel": conv0}, "conv1": {"kernel": conv1}},
        "r3d": {"layer1_0": {"conv1": {"kernel": block},
                             "downsample_conv": {"kernel": down}}}}}
    sd = from_jax_variables(tree)
    assert sd["cnn.conv1.weight"].shape == (16, 8, 3)
    np.testing.assert_array_equal(
        sd["cnn.conv1.weight"].numpy(),
        conv1.reshape(3, 8, 16).transpose(2, 1, 0))
    assert sd["r3d.layer1_0.conv1.weight"].shape == (5, 4, 3, 3, 3)
    np.testing.assert_array_equal(sd["r3d.layer1_0.conv1.weight"].numpy(),
                                  block.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd["r3d.layer1_0.downsample_conv.weight"].numpy(),
        down.transpose(4, 3, 0, 1, 2))
