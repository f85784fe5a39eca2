"""Port int8 serving (utils/quantize.py, serve.Predictor(quantize=...))
against the JAX package's utils/quantize.py and Predictor, on the CPU.

- The selection rules and round trips mirror tests/test_quantize.py
  (:13-56, :84-100, :119-145, :256-266) on torch-layout weights.
- Quantize + dequantize of `from_jax_variables(params)` equals the bridge's
  conversion of JAX's `dequantize_params(quantize_params(params))` bit for
  bit, for the flagship, a small tri-modal model and models with VGG, R3D,
  wav2vec and GRU weights.
- `int8_matmul` against JAX's on the same x and weights: equal int32 sums
  where the activation codes are equal, outputs within 1e-6 relative.
- The quantized Predictor against JAX's on the same weights: int8 at the
  port's f32 serving tolerance (1e-4 on probabilities,
  tests/test_torch_serve.py:64); w8a8 within 1e-3 of the largest logit
  once each layer takes the JAX run's activation codes (the int32 sums are
  exact, so the two differ only where a code rounds the other way, and one
  such flip moves everything after it by ~1/127: the codes that differed
  are counted); and each within the JAX tests' own tolerances against f32
  (int8 0.05, w8a8 0.2) as the outer guard.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodalaggressionrecognition_tpu.serve import Predictor as JaxPredictor
from multimodalaggressionrecognition_tpu.utils import quantize as jq
from multimodalaggressionrecognition_tpu_torch.cli import export_model
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    Linear, MultiheadSelfAttention, TransformerEncoder, seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.nn1d import Conv1d
from multimodalaggressionrecognition_tpu_torch.models.nn3d import Conv3d
from multimodalaggressionrecognition_tpu_torch.models.rnn import GRU
from multimodalaggressionrecognition_tpu_torch.serve import Predictor
from multimodalaggressionrecognition_tpu_torch.utils import quantize as tq
from multimodalaggressionrecognition_tpu_torch.utils.quantize import (
    QTensor, dequantize_params, int8_matmul, int8_mm, quantize_model_,
    quantize_params, quantize_tensor, split_w8a8, tree_nbytes)
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_roundtrip_error_bounded_per_channel():
    rng = np.random.default_rng(0)
    # channels (axis 0 in torch's layout) of very different magnitudes:
    # per-channel scales keep the error ~1/254 of each channel's own range
    w = rng.standard_normal((16, 64)).astype(np.float32)
    w *= np.logspace(-2, 2, 16, dtype=np.float32)[:, None]
    qt = quantize_tensor(torch.from_numpy(w))
    back = dequantize_params({"w": qt})["w"].numpy()
    amp = np.abs(w).max(axis=1)
    assert np.all(np.abs(back - w).max(axis=1) <= amp / 127.0 + 1e-9)


def test_selection_rules():
    m = nn.Module()
    m.dense = nn.Linear(64, 64)
    m.bn = nn.BatchNorm1d(512)
    m.tiny = nn.Linear(2, 2, bias=False)
    m.register_buffer("step", torch.tensor(3))
    params = dict(m.named_parameters())
    q = quantize_params({**params, "step": m.step}, min_size=1024)
    assert q["dense.weight"].q.dtype == torch.int8       # quantized
    assert q["dense.bias"].dtype == torch.float32         # 1-D kept
    assert q["bn.weight"].dtype == torch.float32          # 1-D kept
    assert q["tiny.weight"].dtype == torch.float32        # below min_size
    assert q["step"].dtype == torch.int64                 # non-float kept
    back = dequantize_params(q)
    assert back["dense.weight"].shape == (64, 64)
    assert back["step"] == 3
    # footprint: the 64x64 weight drops 4x (less the per-channel scales)
    assert tree_nbytes(q) < tree_nbytes(params) * 0.45


def test_conv_kernel_channel_scales():
    w = torch.randn((32, 16, 3, 3, 3), generator=torch.Generator()
                    .manual_seed(1))  # Conv3d (C_out, C_in, kt, kh, kw)
    qt = quantize_tensor(w)
    assert qt.scale.shape == (32,)
    back = dequantize_params({"w": qt})["w"]
    assert (back - w).abs().max() <= w.abs().max() / 127.0 + 1e-9


def test_bias_table_not_quantized():
    """Lookup and bias tables shaped like kernels stay float (Swin's
    relative_position_bias_table is added to the scores directly)."""
    params = {
        "attn.relative_position_bias_table": torch.ones((2535, 3)),
        "attn.qkv.weight": torch.ones((288, 96)),
        "tok_embedding": torch.ones((1000, 64)),
    }
    q = quantize_params(params)
    assert q["attn.relative_position_bias_table"].dtype == torch.float32
    assert q["tok_embedding"].dtype == torch.float32
    assert q["attn.qkv.weight"].q.dtype == torch.int8


def test_skip_names_exempt_leaves_not_subtrees():
    """The skip names match a parameter's own name only: a module named
    e.g. text_embedding still has its matmul weights quantized."""
    params = {"text_embedding.kernel.weight": torch.ones((64, 64)),
              "text_embedding.pos_embed": torch.ones((64, 64))}
    q = quantize_params(params, min_size=1)
    assert q["text_embedding.kernel.weight"].q.dtype == torch.int8
    assert q["text_embedding.pos_embed"].dtype == torch.float32


class _Mixed(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear1 = Linear(64, 64)
        self.self_attn = MultiheadSelfAttention(32, 4)
        self.gru = GRU(64, 64)
        self.conv3d = Conv3d(8, 16, (3, 3, 3))
        self.conv1d = Conv1d(16, 32, 3)


def test_split_w8a8_selection():
    """Only the 2-D matmul weights of quant-aware modules (Linear, the
    attention's packed in_proj and out_proj, Conv1d) split into bare int8
    + scale; RNN gates and 3-D convs stay weight-only."""
    m = _Mixed()
    p, quant = split_w8a8(quantize_params(dict(m.named_parameters()),
                                          min_size=1), m)
    assert p["linear1.weight"].dtype == torch.int8
    assert quant["linear1.weight_scale"].shape == (64,)
    assert p["self_attn.in_proj_weight"].dtype == torch.int8
    assert quant["self_attn.out_proj.weight_scale"].shape == (32,)
    assert p["conv1d.weight"].dtype == torch.int8
    assert isinstance(p["gru.weight_ih_l0"], QTensor)
    assert not any(k.startswith("gru.") for k in quant)
    assert isinstance(p["conv3d.weight"], QTensor)
    assert p["linear1.bias"].dtype == torch.float32

    quantize_model_(m, "w8a8")
    assert m.linear1.weight.dtype == torch.int8
    assert m.linear1.weight_scale.shape == (64,)
    assert m.conv1d.weight.dtype == torch.int8
    # weight-only: an int8 parametrization that rebuilds the float weight
    assert m.gru.weight_ih_l0.dtype == torch.float32
    assert m.gru.parametrizations.weight_ih_l0.original.dtype == torch.int8
    assert m.conv3d.parametrizations.weight.original.dtype == torch.int8


def _jax_shapes(entry, example, **kw):
    jmod = importlib.import_module(
        f"multimodalaggressionrecognition_tpu.cli.{entry}")
    tmod = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{entry}")
    from multimodalaggressionrecognition_tpu.cli import (
        export_model as jexport)

    jmodel = jmod.make_model(jexport._entry_config_cls(jmod)(**kw))
    port = tmod.make_model(export_model._entry_config_cls(tmod)(**kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example)
    return shapes, getattr(port, "jax_renames", ())


def _leaf(shape):
    return {"data": np.zeros(shape, np.float32),
            "present": np.ones((1,), np.float32)}


def _flagship():
    from test_torch_flagship import flagship_pair

    return flagship_pair(seed=2)[1], ()


def _trimodal():
    from multimodalaggressionrecognition_tpu.cli import train_multimodal
    from test_torch_trimodal import MODALITIES, SIZES, batch

    jmodel = train_multimodal.build_model(
        train_multimodal.MultimodalConfig(**SIZES), MODALITIES)
    example = {m: {k: np.zeros_like(v) for k, v in d.items()}
               for m, d in batch(1).items()}
    return random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), example), seed=5), ()


def _vgg():
    shapes, renames = _jax_shapes(
        "train_audio_transformer", {"audio": _leaf((1, 4000))}, arch="vgg",
        n_fft=256)
    # the classifier's 25088 x 4096 fc1 is cut to a narrow one: the VGG's
    # 4-D conv kernels are what this case is about
    head = shapes["params"]["vgg"]
    for name, shape in (("fc1", (64, 32)), ("fc2", (32, 32)),
                        ("fc3", (32, 2))):
        head[name] = {"kernel": jax.ShapeDtypeStruct(shape, jnp.float32),
                      "bias": jax.ShapeDtypeStruct(shape[1:], jnp.float32)}
    return random_variables(shapes, seed=6), renames


def _r3d():
    shapes, renames = _jax_shapes(
        "train3dcnn", {"video": _leaf((1, 8, 32, 32, 3))}, frame_num=8,
        video_size=32)
    return random_variables(shapes, seed=7), renames


def _wav2vec():
    from multimodalaggressionrecognition_tpu.models import wav2vec as jw
    from test_torch_wav2vec import SMALL

    jmodel = jw.Wav2Vec2Model(jw.Wav2Vec2Config(**SMALL))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 4000), np.float32))
    return random_variables(shapes, seed=8), ()


def _gru():
    shapes, renames = _jax_shapes(
        "train_video_rnn", {"video": _leaf((1, 5, 64))}, feature_dim=64,
        hidden_size=64)
    return random_variables(shapes, seed=9), renames


@pytest.mark.parametrize("make", [_flagship, _trimodal, _vgg, _r3d,
                                  _wav2vec, _gru],
                         ids=["flagship", "trimodal", "vgg", "r3d",
                              "wav2vec", "gru"])
def test_quantized_weights_equal_jax_bit_for_bit(make):
    variables, renames = make()
    variables = jax.tree.map(np.asarray, variables)
    jqp = jq.quantize_params(variables["params"])
    want = from_jax_variables(
        {"params": jax.tree.map(np.asarray, jq.dequantize_params(jqp)),
         "batch_stats": variables.get("batch_stats", {})}, renames)
    qp = quantize_params(from_jax_variables(variables, renames))
    got = dequantize_params(qp)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    n_jax = sum(1 for leaf in jax.tree.leaves(
        jqp, is_leaf=jq._is_quantized_leaf) if jq._is_quantized_leaf(leaf))
    assert sum(isinstance(v, QTensor) for v in qp.values()) == n_jax > 0


@pytest.mark.parametrize("shape", [(4, 7, 64, 32), (8, 1536, 2)],
                         ids=["4x7x64-32", "heads-8x1536-2"])
def test_int8_matmul_matches_jax(shape):
    """The same codes give the same int32 sums (N = 2 and 8 rows take
    int8_mm's zero padding); the outputs agree within 1e-6 relative."""
    *lead, k, n = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    qd = jq._quantize_array(jnp.asarray(w.T))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), qd["q"],
                                     qd["scale"].reshape(-1)))
    qt = quantize_tensor(torch.from_numpy(w))
    assert np.array_equal(qt.q.numpy(), np.asarray(qd["q"]).T)
    xq, _ = tq.quantize_activations(torch.from_numpy(x))
    xf = jnp.asarray(x)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True) / 127.0, 1e-12)
    jcodes = np.asarray(jnp.clip(jnp.round(xf / xs), -127, 127))
    assert np.array_equal(xq.numpy(), jcodes.astype(np.int8))
    acc = int8_mm(xq.reshape(-1, k), qt.q).numpy()
    assert np.array_equal(
        acc, xq.reshape(-1, k).numpy().astype(np.int64)
        @ qt.q.numpy().astype(np.int64).T)
    got = int8_matmul(torch.from_numpy(x), qt.q, qt.scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_int8_matmul_error_bounded():
    """w8a8 stays within the combined quantization error of a float
    matmul (tests/test_quantize.py:103)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 7, 64), generator=g)
    w = torch.randn((32, 64), generator=g)
    qt = quantize_tensor(w)
    got = int8_matmul(x, qt.q, qt.scale)
    amp = x.abs().max() * w.abs().max()
    assert (got - x @ w.T).abs().max() < amp * 64 / 127.0 * 0.2
    assert got.shape == (4, 7, 32)


def test_w8a8_encoder_parity():
    """A post-LN encoder with its Linear and attention in w8a8 stays near
    the float forward (tests/test_quantize.py:169, 0.15)."""
    m = seeded_init_(TransformerEncoder(64, 4, 2, dim_feedforward=128,
                                        dropout=0.0), 0).eval()
    x = torch.randn((3, 10, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = m(x)
        quantize_model_(m, "w8a8", min_size=1)
        assert m.layers[0].linear1.weight.dtype == torch.int8
        got = m(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.15)


def test_w8a8_conv1d_dequant_path():
    """CNN1D convs under w8a8 hold int8 + scale and dequantize inline
    (tests/test_quantize.py:190, 0.1 and the same argmax; 16 000 samples,
    as torch's max pool refuses the empty window 8 000 reach)."""
    from multimodalaggressionrecognition_tpu_torch.models.cnn1d import CNN1D

    m = seeded_init_(CNN1D(class_num=4), 0).eval()
    x = torch.randn((2, 16000), generator=torch.Generator().manual_seed(6))
    x = x * 0.1
    with torch.no_grad():
        ref = m(x)
        quantize_model_(m, "w8a8")
        assert m.extractor.conv1.weight.dtype == torch.int8
        got = m(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.1)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


class _JaxCodes:
    """Record the JAX w8a8 forward's activation codes (a callback in the
    jitted program, in program order), then hand them to the port's
    layers in the same order, counting the port codes that differed."""

    def __init__(self, monkeypatch):
        self.codes, self.i, self.differ, self.total = [], 0, 0, 0
        self.monkeypatch = monkeypatch

    def record_jax(self):
        orig = jq.int8_matmul

        def recording(x, qkernel, wscale, out_dtype=None):
            xf = x.astype(jnp.float32)
            xs = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True)
                             / 127.0, 1e-12)
            xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
            jax.debug.callback(lambda a: self.codes.append(np.asarray(a)),
                               xq, ordered=True)
            return orig(x, qkernel, wscale, out_dtype)

        self.monkeypatch.setattr(jq, "int8_matmul", recording)

    def replay_port(self):
        orig = tq.quantize_activations

        def replaying(x):
            xq, xs = orig(x)
            want = torch.tensor(self.codes[self.i]).reshape(xq.shape)
            self.i += 1
            self.differ += int((want != xq).sum())
            self.total += xq.numel()
            return want, xs

        self.monkeypatch.setattr(tq, "quantize_activations", replaying)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _flagship_case():
    from test_torch_flagship import HIDDEN, SAMPLES, TOKENS, flagship_pair

    rng = np.random.default_rng(7)
    request = {
        "audio": (rng.standard_normal((3, SAMPLES)) * 0.1).astype(np.float32),
        "text": rng.standard_normal((3, TOKENS, HIDDEN)).astype(np.float32)}
    return (*flagship_pair(seed=3), request)


def _trimodal_case():
    """tests/test_torch_trimodal.py's model and weights, 3 clips."""
    from multimodalaggressionrecognition_tpu.cli import train_multimodal as j
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_multimodal as t)
    from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
        load_jax_variables)
    from test_torch_trimodal import MODALITIES, SIZES, batch

    jmodel = j.build_model(j.MultimodalConfig(**SIZES), MODALITIES)
    example = {m: {k: np.zeros_like(v) for k, v in d.items()}
               for m, d in batch(1).items()}
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), example), seed=3)
    port = t.build_model(t.MultimodalConfig(**SIZES), MODALITIES)
    port = load_jax_variables(port, variables).eval()
    return jmodel, variables, port, {m: d["data"]
                                     for m, d in batch(3).items()}


@pytest.mark.parametrize("make", [_flagship_case, _trimodal_case],
                         ids=["flagship", "trimodal"])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_predictor_matches_jax(make, mode, monkeypatch, capsys):
    jmodel, variables, port, request = make()
    codes = _JaxCodes(monkeypatch)
    if mode == "w8a8":
        codes.record_jax()
    want = JaxPredictor(jmodel, variables, batch_size=4,
                        quantize=mode).predict(request, return_probs=False)
    f32 = Predictor(copy.deepcopy(port), batch_size=4, device="cpu")
    f32_p = f32.predict(request)
    pred = Predictor(port, batch_size=4, device="cpu", quantize=mode)
    # the weights stay resident as int8 + scales
    assert (tree_nbytes(dict(pred.model.named_parameters()))
            < tree_nbytes(dict(f32.model.named_parameters())) * 0.5)
    if mode == "w8a8":
        codes.replay_port()
    got = pred.predict(request, return_probs=False)
    scale = max(np.abs(want[h]).max() for h in want)
    for head in want:
        if mode == "int8":
            np.testing.assert_allclose(_softmax(got[head]),
                                       _softmax(want[head]), atol=1e-4)
        else:
            assert np.abs(got[head] - want[head]).max() <= 1e-3 * scale
        # the JAX tests' own guards against f32 (test_quantize.py:79, :212)
        np.testing.assert_allclose(_softmax(got[head]), f32_p[head],
                                   atol=0.05 if mode == "int8" else 0.2)
    if mode == "w8a8":
        assert codes.i == len(codes.codes) > 0
        with capsys.disabled():
            print(f"\n{make.__name__} w8a8: {codes.differ} of "
                  f"{codes.total} activation codes differed from the JAX "
                  "run's")
