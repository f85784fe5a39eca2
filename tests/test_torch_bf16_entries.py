"""bf16 on every train entry and on extract_features, against the JAX
package's bf16 (tests/test_precision.py's tolerances).

Under `--compute_dtype bfloat16` the JAX package casts the parameters and
the batch to bf16 and each layer computes in its input's dtype; several
ops return f32 whatever their input (the spectrogram, the bilinear resize,
GRU and LSTM), so a tower after one of them runs in f32 on the
bf16-rounded weights.  For each entry, at small widths and on the same
weights (io/from_jax.py):

- the dtype of every module output the two packages share by name (the
  towers' boundaries among them: extractor, sequence or fusion input,
  head, logits; inside the VGG, the Swin and the R3D the stem and every
  stage) equals the JAX one, taken by flax's `capture_intermediates`;
- the eval-mode bf16 logits: a head whose flow is f32 past the cast
  weights and inputs is held at the entry's f32 tolerance (1e-4 of the
  largest logit); the others' probabilities within 0.03 (`:201`), and the
  summed loss within 5 % (`:168`);
- one bf16 train step keeps the master parameters, the optimizer state,
  the gradients and the BatchNorm statistics in f32, with its loss within
  5 % of the f32 step's (`:144-170`);
- after three f32 steps the bf16 eval confusion equals the f32 one
  (`:174-186`).

extract_features casts every variable, BatchNorm statistics included, and
the clips: the port CLI's bf16 files against the JAX CLI's, on the same
weights, within 0.1 of the largest feature (a tower's output, `:92`), after
the same dtype check.  The JAX side runs without Pallas on the CPU.
"""

import importlib
import os
import re
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import extract_features as jef
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics as jax_head_losses)
from multimodalaggressionrecognition_tpu.utils.precision import (
    cast_floating as jax_cast)
from multimodalaggressionrecognition_tpu_torch.cli import (
    extract_features as tef)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_videos)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, eval_step, forward, head_losses_and_metrics, train_step)
from test_torch_rnn_heads import rnn_variables
from test_torch_train_step import torch_tree
from test_torch_trimodal import random_variables

BF16 = torch.bfloat16
RNN_HEADS = ("LSTM_1_layer", "GRU_1_layer", "Avg")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@dataclass
class Case:
    entry: str          # the CLI module in both packages
    config: str         # its config class
    args: list
    data: dict          # modality -> {field: (shape, kind)}
    heads: tuple = ("main",)
    classes: int = 2
    f32_heads: tuple = ()   # heads whose flow is f32 past the cast inputs
    renames: dict = field(default_factory=dict)  # JAX prefix -> port's
    boundaries: tuple = ()  # port module names that must be compared
    rnn: bool = False       # RNN leaves near their init scale


def _swin(prefix):
    stages = [f"{prefix}.stage{s}_block{b}" for s, n in
              enumerate((2, 2, 6, 2)) for b in range(n)]
    return (f"{prefix}.patch_embed", f"{prefix}.patch_norm", *stages,
            *(f"{prefix}.merge{s}" for s in range(3)), f"{prefix}.norm",
            prefix)


def _r3d(prefix):
    return (f"{prefix}.stem.conv", f"{prefix}.stem",
            *(f"{prefix}.layer{i}_{j}" for i in range(1, 5)
              for j in range(2)))


def _rnn_heads(prefix):
    return tuple(f"{prefix}.heads.{h}.{m}" for h in RNN_HEADS
                 for m in ("sequence_nn", "fc1", "fc2")) + tuple(
        f"{prefix}.heads.{h}" for h in RNN_HEADS)


AUDIO = {"audio": {"data": ((16000,), "wave")}}
CASES = {
    "text": Case(
        "train_text_transformer", "TextConfig",
        ["--hidden_size", "32", "--num_heads", "4", "--num_layers", "1"],
        {"text": {"data": ((9, 32), "normal")}},
        boundaries=("inner.encoder", "inner.encoder.layers.0",
                    "inner.encoder.norm", "inner.fc1", "inner.fc2",
                    "inner")),
    "audio_vgg": Case(
        "train_audio_transformer", "AudioTransformerConfig",
        ["--audio_seconds", "1", "--n_fft", "256"], AUDIO,
        f32_heads=("main",),
        boundaries=tuple(f"vgg.{m}{i}" for i in range(8)
                         for m in ("conv", "bn"))
        + ("vgg.fc1", "vgg.fc2", "vgg.fc3", "vgg")),
    "audio_w2v_transformer": Case(
        "train_audio_transformer", "AudioTransformerConfig",
        ["--arch", "transformer", "--audio_seconds", "1"], AUDIO,
        renames={"head": "heads.main"},
        boundaries=("extractor", *(f"extractor.{m}{i}" for i in range(5)
                                   for m in ("conv", "norm")),
                    "heads.main.encoder", "heads.main.fc1",
                    "heads.main.fc2", "heads.main")),
    "audio_text": Case(
        "train_audio_text", "AudioTextConfig",
        ["--hidden_size", "32", "--audio_samples", "16000", "--text_tokens",
         "9"], {**AUDIO, "text": {"data": ((9, 32), "normal")}},
        boundaries=("inner.audio_extractor.extractor.conv0",
                    "inner.audio_extractor.extractor",
                    "inner.audio_extractor.adaptor", "inner.audio_extractor",
                    "inner.text_extractor.inner.encoder",
                    "inner.text_extractor", "inner.fusion_fc",
                    "inner.cls_fc1", "inner.cls_fc2", "inner")),
    **{f"audio_rnn_{x}": Case(
        "train_audio_rnn", "AudioRnnConfig",
        ["--hidden_size", "16", "--audio_seconds", "1", "--extractor", x],
        AUDIO, heads=RNN_HEADS, rnn=True,
        boundaries=("inner.extractor", "inner.extractor.conv0",
                    *_rnn_heads("inner")))
       for x in ("wav2vec1", "wav2vec2_conv", "cnn1d")},
    "video_rnn": Case(
        "train_video_rnn", "VideoRnnConfig",
        ["--hidden_size", "16", "--feature_dim", "24"],
        {"video": {"data": ((7, 24), "normal")}}, heads=RNN_HEADS, rnn=True,
        f32_heads=("LSTM_1_layer", "GRU_1_layer"),
        boundaries=_rnn_heads("inner")),
    "video_transformer": Case(
        "train_video_transformer", "VideoTransformerConfig",
        ["--video_frames", "8", "--video_size", "32", "--video_window", "4",
         "--num_layers", "1"], {"video": {"data": ((8, 48, 48, 3), "normal")}},
        f32_heads=("main",),
        renames={"Swin3dTExtractor_0": "extractor.backbone"},
        boundaries=_swin("extractor.backbone.backbone")
        + ("extractor.backbone", "extractor", "head.encoder", "head.fc1",
           "head.fc2", "head")),
    "train3dcnn": Case(
        "train3dcnn", "Cnn3DConfig", ["--frame_num", "8", "--video_size", "32"],
        {"video": {"data": ((8, 32, 32, 3), "uniform"),
                   "mask": ((8, 32, 32, 1), "mask")}}, classes=4,
        boundaries=_r3d("r3d") + ("r3d.fc1", "r3d.fc2", "r3d")),
}
B = 3


def _batch(case, seed=0):
    rng = np.random.default_rng(seed)

    def make(shape, kind):
        shape = (B, *shape)
        if kind == "wave":
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if kind == "uniform":
            return rng.uniform(0, 1, shape).astype(np.float32)
        if kind == "mask":
            mask = np.zeros(shape, np.float32)
            mask[0, :, 4:20, 6:25] = 1.0
            mask[1, 1:, 10:31, 0:13] = 1.0
            return mask
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    mods = {m: {f: make(*spec) for f, spec in fields.items()}
            for m, fields in case.data.items()}
    for m in mods:
        mods[m]["present"] = np.ones(B, np.float32)
    mask = np.ones(B, np.float32)
    return {"modalities": mods,
            "labels": {h: (np.arange(B) + i) % case.classes
                       for i, h in enumerate(case.heads)},
            "label_mask": {h: mask for h in case.heads},
            "sample_mask": mask}


def _labels_int32(b):
    b["labels"] = {h: v.astype(np.int32) for h, v in b["labels"].items()}
    return b


def _norm(name):
    return re.sub(r"[/._]+", ".", name).strip(".").lower()


def _dtypes(out):
    """The set of dtype names of the tensors in a (nested) output."""
    if isinstance(out, (tuple, list)):
        return set().union(*(_dtypes(o) for o in out)) if out else set()
    if isinstance(out, dict):
        return _dtypes(list(out.values()))
    dt = getattr(out, "dtype", None)
    return {str(dt).replace("torch.", "")} if dt is not None else set()


def jax_dtypes(intermediates, renames=()):
    """{normalized module path: dtypes of its outputs} from flax's
    captured intermediates."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "__call__":
                path = prefix
                for old, new in dict(renames).items():
                    if path == old or path.startswith(old + "/"):
                        path = new + path[len(old):]
                out[_norm(path)] = _dtypes(v)
            elif isinstance(v, dict):
                walk(v, f"{prefix}/{k}" if prefix else k)

    walk(intermediates, "")
    return out


def port_dtypes(model, run):
    """{normalized module name: dtypes of its output} over one `run()`."""
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[_norm(name)] = _dtypes(out)
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    try:
        result = run()
    finally:
        for h in handles:
            h.remove()
    return seen, result


def assert_same_flow(want, got, boundaries):
    shared = sorted(set(want) & set(got))
    for name in boundaries:
        assert _norm(name) in shared, (name, sorted(got)[:20])
    for name in shared:
        assert got[name] == want[name], (name, got[name], want[name])
    return shared


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(case, JAX model, numpy variables, batch, port config, port
    module) with JAX's bf16 eval outputs and captured dtypes."""
    case = CASES[request.param]
    jcli = importlib.import_module(
        f"multimodalaggressionrecognition_tpu.cli.{case.entry}")
    tcli = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{case.entry}")
    jmodel = jcli.make_model(jax_parse_config(getattr(jcli, case.config),
                                              case.args))
    cfg = parse_config(getattr(tcli, case.config), case.args)
    b = _labels_int32(_batch(case))
    draw = rnn_variables if case.rnn else random_variables
    variables = draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                    b["modalities"]), 1)
    v16 = {"params": jax_cast(variables["params"], jnp.bfloat16),
           **{k: v for k, v in variables.items() if k != "params"}}
    out, state = jax.jit(lambda v, m: jmodel.apply(
        v, m, capture_intermediates=True, mutable=["intermediates"]))(
        v16, jax_cast(b["modalities"], jnp.bfloat16))
    specs = {h: JaxLossSpec("ce") for h in case.heads}
    loss = float(jax_head_losses(out, b, specs, case.classes)[0])
    return (case, cfg, tcli, variables, b,
            {h: np.array(o.astype(jnp.float32)) for h, o in out.items()},
            {h: str(o.dtype) for h, o in out.items()}, loss,
            jax_dtypes(state["intermediates"], case.renames))


def _port(pair):
    case, cfg, tcli, variables = pair[:4]
    return load_jax_variables(tcli.make_model(cfg), variables)


def test_dtype_flow_matches_jax(pair):
    case, _, _, _, b, _, out_dtypes, _, want = pair
    model = _port(pair).eval()
    with torch.no_grad():
        got, out = port_dtypes(model, lambda: forward(
            model, torch_tree(b["modalities"]), "bfloat16"))
    assert {h: str(o.dtype).replace("torch.", "")
            for h, o in out.items()} == out_dtypes
    assert_same_flow(want, got, case.boundaries)


def test_bf16_logits_and_loss_match_jax(pair):
    case, _, _, _, b, want, _, want_loss, _ = pair
    model = _port(pair).eval()
    tb = torch_tree(b)
    with torch.no_grad():
        out = forward(model, tb["modalities"], "bfloat16")
        loss, _ = head_losses_and_metrics(
            out, tb, {h: LossSpec("ce") for h in case.heads}, case.classes)
    for h in case.heads:
        got = out[h].float().numpy()
        assert np.isfinite(got).all(), h
        if h in case.f32_heads:
            np.testing.assert_allclose(got, want[h], rtol=0,
                                       atol=1e-4 * np.abs(want[h]).max(),
                                       err_msg=h)
        else:
            np.testing.assert_allclose(
                torch.softmax(torch.from_numpy(got), -1).numpy(),
                torch.softmax(torch.from_numpy(want[h]), -1).numpy(),
                atol=0.03, err_msg=h)
    assert abs(loss.item() - want_loss) / (abs(want_loss) + 1e-6) < 0.05


def _state(pair, lr=1e-3):
    return create_train_state(_port(pair), OptimizerConfig(learning_rate=lr),
                              "cpu")


def _seeded_step(state, tb, case, dtype=None):
    """A train step whose dropout and mask draws come from a fresh
    generator seeded 0: the same draws in f32 and in bf16."""
    set_generator(state.model, torch.Generator().manual_seed(0))
    return train_step(state, tb, {h: LossSpec("ce") for h in case.heads},
                      case.classes, compute_dtype=dtype)


def test_bf16_train_step_keeps_f32_state(pair):
    case, b = pair[0], pair[4]
    tb = torch_tree(b)
    s16, s32 = _state(pair), _state(pair)
    buffers0 = {n: t.clone() for n, t in s16.model.named_buffers()
                if t.is_floating_point()}
    l16 = _seeded_step(s16, tb, case, "bf16")["total_loss"].item()
    l32 = _seeded_step(s32, tb, case)["total_loss"].item()
    trained = [p for p in s16.model.parameters() if p.requires_grad]
    assert trained
    for p in s16.model.parameters():
        assert p.dtype == torch.float32
    for p in trained:
        assert p.grad.dtype == torch.float32
    for st in s16.optimizer.inner.state.values():
        for v in st.values():
            assert not v.is_floating_point() or v.dtype == torch.float32
    for name, t in s16.model.named_buffers():
        assert not t.is_floating_point() or t.dtype == torch.float32, name
    moved = [n for n, t in s16.model.named_buffers()
             if n in buffers0 and not torch.equal(t, buffers0[n])]
    if case.entry in ("train_audio_transformer", "train3dcnn") and (
            "--arch" not in case.args):
        assert moved  # BatchNorm's running statistics, in f32
    assert np.isfinite(l16)
    assert abs(l16 - l32) / (abs(l32) + 1e-6) < 0.05, (l16, l32)
    assert np.isfinite(_seeded_step(s16, tb, case, "bf16")["total_loss"]
                       .item())


def test_bf16_eval_confusion_matches_f32(pair):
    case, b = pair[0], pair[4]
    tb = torch_tree(b)
    state = _state(pair)
    for _ in range(3):  # off the random weights' symmetry, in f32
        _seeded_step(state, tb, case)
    specs = {h: LossSpec("ce") for h in case.heads}
    m32 = eval_step(state, tb, specs, case.classes)
    m16 = eval_step(state, tb, specs, case.classes, compute_dtype="bf16")
    for h in case.heads:
        np.testing.assert_array_equal(m16[h]["confusion"].numpy(),
                                      m32[h]["confusion"].numpy(),
                                      err_msg=h)


# ------------------------------------------------------ extract_features

BOUNDARIES = {"swin3d_t": _swin("windowed.backbone.backbone"),
              "r3d18": _r3d("windowed.backbone.trunk"),
              "s3d": tuple(f"windowed.backbone.features.{m}" for m in
                           ("stem0", "stem1", "stem2",
                            *(f"inception{i}" for i in range(9))))}


@pytest.mark.parametrize("backbone", sorted(BOUNDARIES))
def test_extract_features_bf16_matches_the_jax_cli(backbone, tmp_path,
                                                   monkeypatch):
    """The dtype of each backbone's stages with every variable cast, then
    the two CLIs' bf16 files on the same weights: the same names and
    shapes, f32 on disk, within 0.1 of the largest feature."""
    vids = str(tmp_path / "vids")
    make_synthetic_videos(vids, n_train=1, n_test=1, frames=16, hw=64)
    args = ["--backbone", backbone, "--frame_num", "16", "--window", "16",
            "--batch_size", "1", "--compute_dtype", "bfloat16"]
    jmodel = jef.make_extractor(jax_parse_config(jef.ExtractConfig, args))
    x = (np.random.default_rng(0).standard_normal((1, 16, 64, 64, 3))
         * 0.5).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x), seed=1)
    v16 = jax_cast(variables, jnp.bfloat16)
    _, state = jax.jit(lambda v, c: jmodel.apply(
        v, c, capture_intermediates=True, mutable=["intermediates"]))(
        v16, x.astype(jnp.bfloat16))
    model = load_jax_variables(
        tef.make_extractor(parse_config(tef.ExtractConfig, args)),
        variables).eval().to(BF16)
    with torch.inference_mode():
        got, _ = port_dtypes(model, lambda: model(torch.from_numpy(x)
                                                  .to(BF16)))
    assert_same_flow(jax_dtypes(state["intermediates"]), got,
                     BOUNDARIES[backbone])

    make = jef.make_extractor

    def jax_extractor(cfg):  # the JAX CLI draws its own init: pin it
        m = make(cfg)
        object.__setattr__(m, "init", lambda *a, **k: variables)
        return m

    monkeypatch.setattr(jef, "make_extractor", jax_extractor)
    monkeypatch.setattr(
        "multimodalaggressionrecognition_tpu_torch.models.layers."
        "seeded_init_", lambda m, seed: load_jax_variables(m, variables))
    common = ["--files_root", vids, *args]
    jef.main(common + ["--out_root", str(tmp_path / "jax")])
    tef.main(common + ["--out_root", str(tmp_path / "port"), "--device",
                       "cpu"])
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(names) == 2
    for rel in names:
        want = np.load(tmp_path / "jax" / rel)
        got = np.load(tmp_path / "port" / rel)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (1, tef_dims[backbone])
        np.testing.assert_allclose(got, want,
                                   atol=0.1 * np.abs(want).max(),
                                   err_msg=rel)


tef_dims = {"swin3d_t": 768, "r3d18": 512, "s3d": 1024}
