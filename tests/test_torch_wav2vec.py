"""The port's wav2vec encoders (models/wav2vec.py) and the blocks they add
(models/nn1d.py `GroupNorm` and the bias-free `Conv1d`, the GELU and pre-LN
`TransformerEncoderLayer` of models/layers.py) against the JAX package's.

With the same weights carried by io/from_jax.py (strict load) and both
models deterministic: GroupNorm with one group and with one group per
channel, the bias-free conv, `ConvFeatureEncoder` in both modes,
`Wav2Vec1ConvEncoder`, the positional conv (its even kernel drops the last
frame) and the encoder layer variants within 1e-5; `Wav2Vec2Model` at a
small config, post-LN and pre-LN, with and without `num_outputs`, within
1e-4 (tests/test_wav2vec2_parity.py's model is randomly initialised too).
The frame counts of the entries follow from the conv stacks, and the
bias-free C_in = 1 conv takes `F.conv1d`, as the JAX package takes XLA's
framed matmul there, while the CNN1D stem keeps the framed-conv kernel.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import wav2vec as jw
from multimodalaggressionrecognition_tpu.models.layers import (
    TransformerEncoderLayer as JaxEncoderLayer)
from multimodalaggressionrecognition_tpu.models.nn1d import (
    Conv1d as JaxConv1d, GroupNorm as JaxGroupNorm)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import nn1d
from multimodalaggressionrecognition_tpu_torch.models import wav2vec as tw
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    TransformerEncoderLayer, seeded_init_)
from test_torch_trimodal import random_variables

SMALL = dict(conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)), embed_dim=32,
             num_layers=2, num_heads=4, ff_dim=64, pos_conv_kernel=8,
             pos_conv_groups=4)
POST_LN = jw.Wav2Vec2Config(**SMALL)
PRE_LN = jw.Wav2Vec2Config(**SMALL, extractor_mode="layer_norm",
                           conv_bias=True, layer_norm_first=True)
W2V1_SMALL = ((16, 10, 5), (16, 8, 4), (16, 4, 2))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def conv_frames(length: int, conv_layers) -> int:
    """Frames out of a stack of unpadded strided convs on `length`
    samples."""
    for _, k, s in conv_layers:
        length = (length - k) // s + 1
    return length


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _check(jmodule, tmodule, x, atol=1e-5, seed=1, **kwargs):
    """Bridge random JAX variables into `tmodule`, run both on x; returns
    the port's output and the variables."""
    variables = random_variables(jax.eval_shape(
        jmodule.init, jax.random.PRNGKey(0), x), seed)
    tmodule = load_jax_variables(tmodule, variables).eval()
    want = np.asarray(jax.jit(lambda v, x: jmodule.apply(v, x, **kwargs))(
        variables, x))
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x), **kwargs).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol)
    return got, variables


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_group_norm_matches_jax(groups):
    x = _x((2, 11, 16), scale=3.0) + 1.0
    _check(JaxGroupNorm(num_groups=groups), nn1d.GroupNorm(groups, 16), x)


def test_bias_free_conv_matches_jax_and_takes_f_conv1d(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("the bias-free conv reached the framed conv")

    monkeypatch.setattr(nn1d, "framed_conv1d", no_kernel)
    monkeypatch.setattr(nn1d, "framed_conv1d_trainable", no_kernel)
    conv = nn1d.Conv1d(1, 16, 10, 5, bias=False)
    assert conv.bias is None and [n for n, _ in conv.named_parameters()] == [
        "weight"]
    x = _x((2, 203, 1))
    jconv = JaxConv1d(16, 10, stride=5, use_bias=False)
    variables = jconv.init(jax.random.PRNGKey(3), x)
    assert list(variables["params"]) == ["kernel"]  # no bias leaf
    kernel = np.asarray(variables["params"]["kernel"])  # (K * C_in, C_out)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(kernel.T[:, None, :])))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jconv.apply(variables, x)),
                               atol=1e-5)
    with pytest.raises(AssertionError, match="reached the framed conv"):
        nn1d.Conv1d(1, 16, 10, 5)(torch.zeros(1, 50, 1))  # a stem with bias


@pytest.mark.parametrize("mode,bias", [("group_norm", False),
                                       ("layer_norm", True)])
def test_conv_feature_encoder_matches_jax(mode, bias):
    layers = SMALL["conv_layers"]
    _check(jw.ConvFeatureEncoder(layers, mode, bias),
           tw.ConvFeatureEncoder(layers, mode, bias), _x((2, 400)))


def test_wav2vec1_encoder_matches_jax():
    got, _ = _check(jw.Wav2Vec1ConvEncoder(W2V1_SMALL),
                    tw.Wav2Vec1ConvEncoder(W2V1_SMALL), _x((2, 800)))
    assert got.shape == (2, conv_frames(800, W2V1_SMALL), 16)
    assert (got >= 0).all()  # ReLU last


@pytest.mark.parametrize("kernel", [8, 7])
def test_positional_conv_matches_jax_and_drops_the_even_frame(kernel):
    """Padding k//2 on each side gives T + 1 frames for an even kernel, of
    which the last is dropped; an odd kernel gives T."""
    got, variables = _check(jw.ConvPositionalEmbedding(32, kernel, 4),
                            tw.ConvPositionalEmbedding(32, kernel, 4),
                            _x((2, 13, 32)))
    assert got.shape == (2, 13, 32)
    if kernel % 2 == 0:  # the kept frames are the first T of T + 1
        mod = load_jax_variables(tw.ConvPositionalEmbedding(32, kernel, 4),
                                 variables)
        x = torch.from_numpy(_x((2, 13, 32)))
        full = torch.nn.functional.conv1d(
            x.transpose(1, 2), mod.weight, mod.bias, padding=kernel // 2,
            groups=4)
        assert full.shape[-1] == 14
        np.testing.assert_allclose(
            got, torch.nn.functional.gelu(full[:, :, :13]).transpose(
                1, 2).detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("norm_first", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_variants_match_jax(activation, norm_first):
    _check(JaxEncoderLayer(32, 4, 64, activation=activation,
                           norm_first=norm_first),
           TransformerEncoderLayer(32, 4, 64, activation=activation,
                                   norm_first=norm_first),
           _x((2, 9, 32)))


@pytest.mark.parametrize("num_outputs", [None, 1])
@pytest.mark.parametrize("cfg", [POST_LN, PRE_LN], ids=["post_ln", "pre_ln"])
def test_wav2vec2_model_matches_jax(cfg, num_outputs):
    """Pre-LN applies `encoder_norm` on the full forward only: a truncated
    stack's output is the layer's, unnormalized."""
    x = _x((2, 800), scale=0.5)
    model = tw.Wav2Vec2Model(tw.Wav2Vec2Config(**vars(cfg)))
    got, variables = _check(jw.Wav2Vec2Model(cfg), model, x, atol=1e-4,
                            num_outputs=num_outputs)
    assert got.shape == (2, conv_frames(800, cfg.conv_layers), 32)
    if cfg.layer_norm_first and num_outputs is None:
        model = load_jax_variables(model, variables).eval()
        with torch.no_grad():
            stack = model(torch.from_numpy(x), num_outputs=cfg.num_layers)
            np.testing.assert_allclose(
                got, model.encoder_norm(stack).numpy(), atol=1e-6)


def test_bridge_pos_conv_rule_and_strict_load():
    cfg = POST_LN
    variables = random_variables(jax.eval_shape(
        jw.Wav2Vec2Model(cfg).init, jax.random.PRNGKey(0),
        np.zeros((1, 400), np.float32)), seed=3)
    sd = from_jax_variables(variables)
    kernel = variables["params"]["pos_conv"]["kernel"]  # (K, E/g, E)
    assert kernel.shape == (8, 8, 32)
    np.testing.assert_array_equal(sd["pos_conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    assert "feature_extractor.conv0.bias" not in sd  # bias-free conv0
    model = load_jax_variables(tw.Wav2Vec2Model(cfg), variables)
    assert sorted(sd) == sorted(model.state_dict())


def test_entry_frame_counts():
    """The entries' frames: 10 s at 16 kHz through wav2vec-1 (998) and
    wav2vec-2's conv stack (499), 5 s through wav2vec-1 (498), by the
    modules themselves at narrow widths with the same kernels and
    strides."""
    w2v1 = tw.WAV2VEC1_CONV_LAYERS
    w2v2 = tw.WAV2VEC2_BASE.conv_layers
    assert conv_frames(160000, w2v1) == 998
    assert conv_frames(160000, w2v2) == 499
    assert conv_frames(80000, w2v1) == 498
    narrow = lambda layers: tuple((4, k, s) for _, k, s in layers)  # noqa
    x = torch.zeros(1, 160000)
    with torch.no_grad():
        assert tw.Wav2Vec1ConvEncoder(narrow(w2v1))(x).shape == (1, 998, 4)
        assert tw.ConvFeatureEncoder(narrow(w2v2))(x).shape == (1, 499, 4)
        assert tw.Wav2Vec1ConvEncoder(narrow(w2v1))(
            x[:, :80000]).shape == (1, 498, 4)


def test_presets_match_jax():
    for name in ("WAV2VEC2_BASE", "HUBERT_BASE", "HUBERT_LARGE",
                 "HUBERT_XLARGE"):
        assert vars(getattr(tw, name)) == vars(getattr(jw, name)), name
    assert tw.WAV2VEC1_CONV_LAYERS == jw.WAV2VEC1_CONV_LAYERS


def test_seeded_init_fills_norms_and_the_positional_conv():
    def make():
        return seeded_init_(tw.Wav2Vec2Model(tw.Wav2Vec2Config(
            **dict(SMALL, embed_dim=64, pos_conv_kernel=16))), seed=2)

    torch.manual_seed(0)
    a = make()
    torch.manual_seed(1)
    b = make()
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    norm0 = a.feature_extractor.norm0
    assert torch.equal(norm0.weight, torch.ones(16))
    assert torch.equal(norm0.bias, torch.zeros(16))
    w = a.pos_conv.weight
    std = (4.0 / (16 * 64)) ** 0.5
    assert abs(w.std().item() - std) < 0.05 * std and abs(w.mean()) < 0.1 * std
    assert torch.equal(a.pos_conv.bias, torch.zeros(64))
