"""bf16 compute in the port against the JAX package's (tests/test_precision.py).

Each port bf16 result is held to the JAX package's bf16 result on the same
weights (io/from_jax.py) and to the port's own f32 result, at the JAX
test's tolerance: atol 0.05 on a layer's activations and the stem (`:78`),
0.1 of the largest on the audio tower (`:92`), 0.15 on the transformer
(`:107`), 5 % on the loss (`:168`), equal confusion matrices (`:185`) and
0.03 on served probabilities (`:201`).  The tri-modal model with a
one-stage Swin (an unshifted and a shifted block: the plain K2, K3 and K4)
is held at the probabilities' 0.03 and the loss's 5 %, its Swin gradients
at 0.1 of the largest (or twice JAX's own bf16-to-f32 distance).  K2's and K3's
plain versions on bf16 inputs are held to the Pallas kernel in interpret
mode at 1e-2 of the largest output, and the plain roll to `pallas_roll`
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from multimodalaggressionrecognition_tpu.models import cnn1d as jcnn
from multimodalaggressionrecognition_tpu.models import layers as jlayers
from multimodalaggressionrecognition_tpu.models import nn1d as jnn1d
from multimodalaggressionrecognition_tpu.models.fusion import (
    EqualSizedTransformerModalitiesFusion as JaxFusion)
from multimodalaggressionrecognition_tpu.models.physverb import (
    IdentityExtractor as JaxIdentity)
from multimodalaggressionrecognition_tpu.models.physverb import (
    PhysVerbClassifierConcatFeatures as JaxClassifier)
from multimodalaggressionrecognition_tpu.models.physverb import (
    PhysVerbModel as JaxPhysVerb)
from multimodalaggressionrecognition_tpu.models.video_extractors import (
    WindowedVideoExtractor as JaxWindowed)
from multimodalaggressionrecognition_tpu.serve import (
    Predictor as JaxPredictor)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.state import (
    create_train_state as jax_train_state)
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics as _jax_head_losses)
from multimodalaggressionrecognition_tpu.train.steps import (
    make_eval_step, make_train_step)
from multimodalaggressionrecognition_tpu.utils.precision import (
    cast_floating as jax_cast)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import cnn1d
from multimodalaggressionrecognition_tpu_torch.models import layers
from multimodalaggressionrecognition_tpu_torch.models import nn1d
from multimodalaggressionrecognition_tpu_torch.models.fusion import (
    EqualSizedTransformerModalitiesFusion)
from multimodalaggressionrecognition_tpu_torch.models.physverb import (
    IdentityExtractor, PhysVerbClassifierConcatFeatures, PhysVerbModel)
from multimodalaggressionrecognition_tpu_torch.models.video_extractors import (
    WindowedVideoExtractor)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.roll import (
    roll_reference)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, window_attention_bwd_reference)
from multimodalaggressionrecognition_tpu_torch.serve import Predictor
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, eval_step, forward, head_losses_and_metrics, train_step)
from multimodalaggressionrecognition_tpu_torch.utils.precision import (
    cast_floating, resolve_dtype)
from test_torch_roll import pallas_roll  # noqa: F401 (a fixture)
from test_torch_swin_trainable import JaxTinySwin, TinySwin

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_call(module, *args):
    """module(*args) on bf16 casts of its floating parameters and inputs
    (buffers stay f32), as a bf16 train or eval step runs it."""
    params = cast_floating(dict(module.named_parameters()), BF16)
    return functional_call(module, params,
                           tuple(cast_floating(a, BF16) for a in args))


def test_resolve_dtype():
    assert resolve_dtype(None) is None
    assert resolve_dtype("bf16") == BF16
    assert resolve_dtype("bfloat16") == BF16
    assert resolve_dtype("float32") == torch.float32
    with pytest.raises(ValueError):
        resolve_dtype("fp8")


def test_cast_floating_leaves_ints_alone():
    tree = {"w": torch.ones((2, 2)), "i": torch.zeros((3,), dtype=torch.int32),
            "nested": {"x": torch.ones(3)}}
    out = cast_floating(tree, "bf16")
    assert out["w"].dtype == BF16 and out["nested"]["x"].dtype == BF16
    assert out["i"].dtype == torch.int32
    assert cast_floating(tree, None) is tree


def _conv_port(variables, c_in):
    """A port Conv1d loaded with a bare JAX Conv1d's (K*C_in, C_out)
    kernel."""
    p = variables["params"]
    k_c, c_out = p["kernel"].shape
    conv = nn1d.Conv1d(c_in, c_out, k_c // c_in, 1, 1)
    conv.load_state_dict({
        "weight": torch.from_numpy(np.asarray(p["kernel"]).reshape(
            k_c // c_in, c_in, c_out).transpose(2, 1, 0).copy()),
        "bias": torch.from_numpy(np.array(p["bias"]))})
    return conv


LAYERS = {
    "linear": (lambda: jlayers.TorchLinear(8), lambda v: load_jax_variables(
        torch.nn.Linear(8, 8), v), (2, 5, 8)),
    "mha": (lambda: jlayers.MultiheadSelfAttention(8, 2),
            lambda v: load_jax_variables(layers.MultiheadSelfAttention(8, 2),
                                         v), (2, 5, 8)),
    "conv1d": (lambda: jnn1d.Conv1d(8, 3, stride=1, padding=1),
               lambda v: _conv_port(v, 4), (2, 16, 4)),
    "batchnorm": (lambda: jnn1d.BatchNorm1d(),
                  lambda v: load_jax_variables(nn1d.BatchNorm1d(4), v),
                  (2, 16, 4)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layers_preserve_bf16(name):
    make_jax, make_port, shape = LAYERS[name]
    x32 = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    module = make_jax()
    variables = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0),
                                                     jnp.asarray(x32)))
    if name == "batchnorm":  # non-trivial running statistics
        rng = np.random.default_rng(1)
        variables["batch_stats"] = {
            "mean": 0.1 * rng.standard_normal(4).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    want16 = module.apply(jax_cast(variables, "bf16"),
                          jnp.asarray(x32).astype(jnp.bfloat16))
    port = make_port(variables).eval()
    with torch.no_grad():
        y16 = bf16_call(port, torch.from_numpy(x32))
        y32 = port(torch.from_numpy(x32))
    assert y16.dtype == BF16 and y32.dtype == torch.float32
    assert want16.dtype == jnp.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), _np(want16), atol=0.05)
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=0.05)


def test_stem_conv_bf16_roundtrip():
    """The stem runs its kernel (here the plain version) in f32 with a cast
    in and out, as JAX's Pallas stem does."""
    jconv = jnn1d.Conv1d(8, 160, stride=40, padding=80, use_pallas=True)
    x = (np.random.default_rng(0).standard_normal((2, 2000)) * 0.1).astype(
        np.float32)[..., None]
    variables = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    want16 = jconv.apply(jax_cast(variables, "bf16"),
                         jnp.asarray(x).astype(jnp.bfloat16))
    port = _conv_port(variables, 1)
    port.padding, port.stride = 80, 40
    with torch.no_grad():
        y16 = bf16_call(port, torch.from_numpy(x))
        y32 = port(torch.from_numpy(x))
    assert y16.dtype == BF16
    np.testing.assert_allclose(y16.float().numpy(), _np(want16), atol=0.05)
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=0.05)


def test_audio_tower_bf16_tracks_f32():
    jmodel = jcnn.AudioCnn1DExtractorWrapper(hidden_size=64)
    x = (np.random.default_rng(1).standard_normal((2, 20000)) * 0.1).astype(
        np.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.asarray(x)))
    want16 = jmodel.apply(jax_cast(variables, "bf16"),
                          jnp.asarray(x).astype(jnp.bfloat16))
    port = load_jax_variables(cnn1d.AudioCnn1DExtractorWrapper(64),
                              variables).eval()
    with torch.no_grad():
        y16 = bf16_call(port, torch.from_numpy(x))
        y32 = port(torch.from_numpy(x))
    assert y16.dtype == BF16
    scale = np.abs(y32.numpy()).max() + 1e-6
    for ref in (y32.numpy(), _np(want16)):
        rel = np.abs(y16.float().numpy() - ref).max() / scale
        assert rel < 0.1, rel


def test_transformer_bf16_tracks_f32():
    jenc = jlayers.TransformerEncoder(d_model=32, nhead=4, num_layers=2,
                                      dim_feedforward=64)
    x = np.random.default_rng(2).standard_normal((2, 6, 32)).astype(
        np.float32)
    mask = np.zeros((2, 6), bool)
    mask[:, 4:] = True
    variables = jax.tree.map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)))
    want16 = jenc.apply(jax_cast(variables, "bf16"),
                        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask))
    port = load_jax_variables(layers.TransformerEncoder(32, 4, 2, 64),
                              variables).eval()
    with torch.no_grad():
        y16 = bf16_call(port, torch.from_numpy(x), torch.from_numpy(mask))
        y32 = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert y16.dtype == BF16
    for ref in (y32.numpy(), _np(want16)):
        assert np.abs(y16.float().numpy() - ref).max() < 0.15


# --------------------------------------------------------------- flagship

def _tiny_flagship(jax_side: bool, hidden=32, feature_shapes=None):
    if jax_side:
        return JaxPhysVerb(
            extractors={"audio": jcnn.AudioCnn1DExtractorWrapper(
                hidden_size=hidden), "text": JaxIdentity()},
            fusion=JaxFusion(1, hidden, 4),
            classifier=JaxClassifier(
                class_num=2, adaptor_sizes={"audio": (hidden, 16),
                                            "text": (hidden, 16)}),
            feature_shapes=feature_shapes or {}, modalities=("audio", "text"))
    return PhysVerbModel(
        extractors={"audio": cnn1d.AudioCnn1DExtractorWrapper(hidden),
                    "text": IdentityExtractor()},
        fusion=EqualSizedTransformerModalitiesFusion(1, hidden, 4),
        classifier=PhysVerbClassifierConcatFeatures(
            class_num=2, adaptor_sizes={"audio": (hidden, 16),
                                        "text": (hidden, 16)}),
        feature_shapes=feature_shapes, modalities=("audio", "text"))


def _flagship_batch(b=4, audio_len=20000, text_len=6, hidden=32):
    rng = np.random.default_rng(3)
    return {
        "modalities": {
            "audio": {"data": rng.standard_normal(
                (b, audio_len)).astype(np.float32) * 0.1,
                "present": np.ones((b,), np.float32)},
            "text": {"data": rng.standard_normal(
                (b, text_len, hidden)).astype(np.float32),
                "present": np.ones((b,), np.float32)},
        },
        "labels": {"phys": (np.arange(b) % 2).astype(np.int32),
                   "verb": np.zeros((b,), np.int32)},
        "label_mask": {"phys": np.ones((b,), np.float32),
                       "verb": np.ones((b,), np.float32)},
        "sample_mask": np.ones((b,), np.float32),
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


JSPECS = {"phys": JaxLossSpec("ce"), "verb": JaxLossSpec("ce")}
SPECS = {"phys": LossSpec("ce"), "verb": LossSpec("ce")}


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, its numpy variables, batch)."""
    jmodel, b = _tiny_flagship(True), _flagship_batch()
    state = jax_train_state(jmodel, b["modalities"], optax.adam(1e-3))
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          **state.model_state})
    return jmodel, variables, b


def _port_state(variables, lr=1e-3):
    return create_train_state(
        load_jax_variables(_tiny_flagship(False), variables),
        OptimizerConfig(learning_rate=lr), "cpu")


def _seeded_step(state, tb, dtype=None):
    """A train step whose dropout draws come from a fresh generator seeded
    0: the same masks in f32 and in bf16."""
    set_generator(state.model, torch.Generator().manual_seed(0))
    return train_step(state, tb, SPECS, 2, compute_dtype=dtype)


def test_bf16_train_step_keeps_f32_master_state(flagship):
    jmodel, variables, b = flagship
    jstate = jax_train_state(jmodel, b["modalities"], optax.adam(1e-3))
    jstate = jstate.replace(params=variables["params"],
                            model_state={"batch_stats":
                                         variables["batch_stats"]})
    tb = _torch(b)
    s16, s32 = _port_state(variables), _port_state(variables)
    l16 = _seeded_step(s16, tb, "bf16")["total_loss"].item()
    l32 = _seeded_step(s32, tb)["total_loss"].item()
    for p in s16.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for st in s16.optimizer.inner.state.values():
        for v in st.values():
            assert not v.is_floating_point() or v.dtype == torch.float32
    for buf in s16.model.buffers():
        assert buf.dtype == torch.float32
    assert np.isfinite(l16)
    assert abs(l16 - l32) / (abs(l32) + 1e-6) < 0.05, (l16, l32)
    # the deterministic (eval-mode) bf16 loss of the same weights: the
    # port's against the JAX package's
    fresh = _port_state(variables)
    got = eval_step(fresh, tb, SPECS, 2, compute_dtype="bf16")["total_loss"]
    want = make_eval_step(jmodel, JSPECS, 2, compute_dtype="bf16")(jstate, b)
    want = float(want["total_loss"])
    assert abs(got.item() - want) / (abs(want) + 1e-6) < 0.05, (got, want)
    # one more step runs from the updated state
    l16b = _seeded_step(s16, tb, "bf16")["total_loss"].item()
    assert np.isfinite(l16b)


def test_bf16_train_mode_step_moves_f32_bn_statistics(flagship):
    """Train mode: BatchNorm takes its batch statistics in f32 from the
    bf16 activations, and its running statistics stay f32 and move."""
    _, variables, b = flagship
    state = _port_state(variables)
    bn = state.model.extractors["audio"].extractor.bn1
    mean0 = bn.running_mean.clone()
    train_step(state, _torch(b), SPECS, 2, compute_dtype="bf16")
    assert bn.running_mean.dtype == torch.float32
    assert not torch.equal(bn.running_mean, mean0)


def test_bf16_eval_step_matches_f32_confusion(flagship):
    jmodel, variables, b = flagship
    tb = _torch(b)
    state = _port_state(variables)
    jstate = jax_train_state(jmodel, b["modalities"], optax.adam(1e-3))
    jstate = jstate.replace(params=variables["params"],
                            model_state={"batch_stats":
                                         variables["batch_stats"]})
    step = make_train_step(jmodel, JSPECS, num_classes=2, donate=False)
    for i in range(3):  # off init symmetry, in f32 on both sides
        jstate, _ = step(jstate, b, jax.random.PRNGKey(i))
    load_jax_variables(state.model, jax.tree.map(
        np.asarray, {"params": jstate.params, **jstate.model_state}))
    m32 = eval_step(state, tb, SPECS, 2)
    m16 = eval_step(state, tb, SPECS, 2, compute_dtype="bf16")
    j16 = make_eval_step(jmodel, JSPECS, 2, compute_dtype="bf16")(jstate, b)
    for head in ("phys", "verb"):
        np.testing.assert_array_equal(m16[head]["confusion"].numpy(),
                                      m32[head]["confusion"].numpy())
        np.testing.assert_array_equal(m16[head]["confusion"].numpy(),
                                      np.asarray(j16[head]["confusion"]))


def test_predictor_bf16(flagship):
    jmodel, _, b = flagship
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     b["modalities"]))
    mods = {m: b["modalities"][m]["data"][:2] for m in b["modalities"]}
    j16 = JaxPredictor(jmodel, variables, batch_size=4,
                       compute_dtype="bf16").predict(mods)
    port = load_jax_variables(_tiny_flagship(False), variables)
    p32 = Predictor(port, batch_size=4, device="cpu").predict(mods)
    p16 = Predictor(port, batch_size=4, device="cpu",
                    compute_dtype="bf16").predict(mods)
    for head in p32:
        assert p16[head].dtype == np.float32
        np.testing.assert_allclose(p16[head], p32[head], atol=0.03)
        np.testing.assert_allclose(p16[head], j16[head], atol=0.03)


def test_missing_modality_bf16_tracks_jax(flagship):
    """A batch without text (the tri-modal set's EMPTY protocol): in both
    packages the zero stub is f32 and promotes the fusion and the heads to
    f32, on the bf16-rounded weights.  The served bf16 probabilities stay
    within 0.03 of the JAX package's bf16 ones and of the port's f32
    ones."""
    jmodel, _, b = flagship
    shapes = {"text": b["modalities"]["text"]["data"].shape[1:]}
    jmodel = _tiny_flagship(True, feature_shapes=shapes)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), {"audio": b["modalities"]["audio"]}))
    mods = {"audio": b["modalities"]["audio"]["data"]}
    j16 = JaxPredictor(jmodel, variables, batch_size=4,
                       compute_dtype="bf16").predict(mods)
    j32 = JaxPredictor(jmodel, variables, batch_size=4).predict(mods)
    port = load_jax_variables(_tiny_flagship(False, feature_shapes=shapes),
                              variables)
    p32 = Predictor(port, batch_size=4, device="cpu").predict(mods)
    p16 = Predictor(port, batch_size=4, device="cpu",
                    compute_dtype="bf16").predict(mods)
    for head in p32:
        np.testing.assert_allclose(p32[head], j32[head], atol=1e-5)
        assert p16[head].dtype == np.float32
        np.testing.assert_allclose(p16[head], p32[head], atol=0.03)
        np.testing.assert_allclose(p16[head], j16[head], atol=0.03)


# -------------------------------------------------------------- tri-modal

HIDDEN = 16  # the one-stage Swin's width (embed 16, depths (2,))
AUDIO, TOKENS, FRAMES, SIZE = 16000, 6, 16, 28


def _trimodal(jax_side: bool):
    sizes = {"audio": (HIDDEN, 8), "text": (HIDDEN, 8), "video": (HIDDEN, 8)}
    if jax_side:
        return JaxPhysVerb(
            extractors={"audio": jcnn.AudioCnn1DExtractorWrapper(
                hidden_size=HIDDEN), "text": JaxIdentity(),
                "video": JaxWindowed(JaxTinySwin(), window=8, freeze=False)},
            fusion=JaxFusion(1, HIDDEN, 2),
            classifier=JaxClassifier(class_num=2, adaptor_sizes=sizes),
            feature_shapes={}, modalities=("audio", "text", "video"))
    return PhysVerbModel(
        extractors={"audio": cnn1d.AudioCnn1DExtractorWrapper(HIDDEN),
                    "text": IdentityExtractor(),
                    "video": WindowedVideoExtractor(TinySwin(), window=8,
                                                    freeze=False)},
        fusion=EqualSizedTransformerModalitiesFusion(1, HIDDEN, 2),
        classifier=PhysVerbClassifierConcatFeatures(class_num=2,
                                                    adaptor_sizes=sizes),
        modalities=("audio", "text", "video"))


def test_trimodal_bf16_tracks_jax():
    """A tri-modal model whose Swin is one stage of two blocks (stage 0 of
    a 16-frame, 28 px clip: the second block is shifted, so K4 rolls and K2
    takes a mask): the served bf16 probabilities within 0.03 of the JAX
    package's bf16 ones and of the port's f32 ones; the deterministic bf16
    loss within 5 % of JAX's, and its backward (K3's plain version) giving
    the Swin tower's gradients within 0.1 of JAX's largest (the audio
    tower's bf16 bound); a bf16 train step within 5 % of the f32 one."""
    rng = np.random.default_rng(4)
    n = 2
    mods = {"audio": (rng.standard_normal((n, AUDIO)) * 0.1),
            "text": rng.standard_normal((n, TOKENS, HIDDEN)),
            "video": rng.standard_normal((n, FRAMES, SIZE, SIZE, 3)) * 0.3}
    mods = {m: v.astype(np.float32) for m, v in mods.items()}
    b = {"modalities": {m: {"data": v, "present": np.ones(n, np.float32)}
                        for m, v in mods.items()},
         "labels": {"phys": np.array([0, 1], np.int32),
                    "verb": np.array([1, 0], np.int32)},
         "label_mask": {h: np.ones(n, np.float32) for h in ("phys", "verb")},
         "sample_mask": np.ones(n, np.float32)}
    jmodel = _trimodal(True)
    init = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), b["modalities"]))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                      if p[-1].key == "relative_position_bias_table" else v),
        init)
    port = load_jax_variables(_trimodal(False), variables)

    want = JaxPredictor(jmodel, variables, batch_size=n,
                        compute_dtype="bf16").predict(mods)
    got16 = Predictor(port, batch_size=n, device="cpu",
                      compute_dtype="bf16").predict(mods)
    got32 = Predictor(port, batch_size=n, device="cpu").predict(mods)
    for head in want:
        np.testing.assert_allclose(got16[head], want[head], atol=0.03)
        np.testing.assert_allclose(got16[head], got32[head], atol=0.03)

    def jax_grads(dtype):
        def loss(params):
            out = jmodel.apply({"params": jax_cast(params, dtype),
                                "batch_stats": variables["batch_stats"]},
                               jax_cast(b["modalities"], dtype), train=False)
            return _jax_head_losses(out, b, JSPECS, 2)[0]

        value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        return float(value), from_jax_variables(
            {"params": jax.tree.map(np.asarray, grads)})

    want_loss, want = jax_grads("bf16")
    _, want32 = jax_grads(None)
    tb = _torch(b)
    port.eval()
    total, _ = head_losses_and_metrics(
        forward(port, tb["modalities"], "bf16"), tb, SPECS, 2)
    total.backward()
    assert abs(total.item() - want_loss) / want_loss < 0.05
    # a gradient that cancels over every token (the patch embedding's bias)
    # moves more under bf16 rounding: each is held to 0.1 of JAX's largest
    # or to twice JAX's own bf16-to-f32 distance, whichever is larger
    swin = {n: p for n, p in port.named_parameters() if ".backbone." in n}
    assert len(swin) > 20
    for name, p in swin.items():
        ref, ref32 = want[name].numpy(), want32[name].numpy()
        scale = np.abs(ref).max()
        own = np.abs(ref - ref32).max() / scale
        err = np.abs(p.grad.numpy() - ref).max() / scale
        assert err <= max(0.1, 2 * own), (name, err, own)

    s16 = create_train_state(load_jax_variables(_trimodal(False), variables),
                             OptimizerConfig(learning_rate=1e-3), "cpu")
    s32 = create_train_state(load_jax_variables(_trimodal(False), variables),
                             OptimizerConfig(learning_rate=1e-3), "cpu")
    l16 = _seeded_step(s16, tb, "bf16")["total_loss"].item()
    l32 = _seeded_step(s32, tb)["total_loss"].item()
    assert abs(l16 - l32) / abs(l32) < 0.05, (l16, l32)


# ------------------------------------------------- kernels' plain versions

def _attention_case(seed=0, w=8, n=24, heads=3, d=8, nw=4):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((w, n, 3 * heads * d)).astype(np.float32)
    bias = (rng.standard_normal((heads, n, n)) * 0.5).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0).astype(
        np.float32)
    g = rng.standard_normal((w, n, heads * d)).astype(np.float32)
    return qkv, bias, mask, g, heads


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def test_plain_attention_bf16_matches_the_pallas_kernel():
    """The Pallas forward and its custom VJP (interpret mode off the TPU)
    on the same bf16 qkv and output gradient."""
    from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
        fused_window_attention as pallas_attention)

    qkv, bias, mask, g, heads = _attention_case()
    q16 = jnp.asarray(qkv).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda q, b: pallas_attention(
        q, b, jnp.asarray(mask), heads), q16, jnp.asarray(bias))
    dq_want, db_want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    t16 = torch.from_numpy(qkv).to(BF16)
    got = attention_core_reference(t16, torch.from_numpy(bias),
                                   torch.from_numpy(mask), heads)
    lse = attention_core_reference(t16, torch.from_numpy(bias),
                                   torch.from_numpy(mask), heads,
                                   with_lse=True)[1]
    dq, db = window_attention_bwd_reference(
        t16, torch.from_numpy(bias), torch.from_numpy(mask),
        torch.from_numpy(g).to(BF16), heads, lse)
    assert got.dtype == dq.dtype == BF16 and db.dtype == torch.float32
    assert want.dtype == dq_want.dtype == jnp.bfloat16
    assert _rel(got.float(), _np(want)) < 1e-2
    assert _rel(dq.float(), _np(dq_want)) < 1e-2
    assert _rel(db, _np(db_want)) < 1e-2


def test_plain_roll_bf16_is_pallas_roll_bit_for_bit(pallas_roll):
    x = np.random.default_rng(5).standard_normal((2, 4, 14, 14, 16)).astype(
        np.float32)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    want = pallas_roll(x16, 3, 3)
    got = roll_reference(torch.from_numpy(x).to(BF16), (0, 3, 3))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
