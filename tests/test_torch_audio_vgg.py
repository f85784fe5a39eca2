"""The spectrogram VGG11-BN entry (cli/train_audio_transformer.py --arch
vgg) against the JAX package's, with the same weights carried by
io/from_jax.py (strict load).

- VGG11BN logits at (2, 64, 64, 3) with 10 classes, eval mode, within 5e-3
  as tests/test_video_models.py holds the JAX one to torchvision's; the
  final map is 2x2 there, so the adaptive 7x7 pool upsamples.
- SpectrogramVGG at tests/test_cli.py's sizes (1 s at 16 kHz, n_fft 256,
  129 bins), both models deterministic (JAX train=False, the port in eval
  mode): logits, and the CE loss and every parameter's gradient within
  1e-4 * max|g_JAX| of that tensor, as tests/test_torch_train_step.py.
- A port train step lowers the loss of a repeated batch and moves the
  BatchNorm statistics; the CLI trains on the CPU and writes its logs and
  checkpoints.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from multimodalaggressionrecognition_tpu.cli import (
    train_audio_transformer as jcli)
from multimodalaggressionrecognition_tpu.models.vgg import (
    VGG11BN as JaxVGG11BN)
from multimodalaggressionrecognition_tpu.ops.video import (
    adaptive_avg_pool_2d)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_audio_transformer as tcli)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.nn3d import Conv2d
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.models.vgg import VGG11BN
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics, train_step)
from test_torch_trimodal import random_variables

# tests/test_cli.py's audio VGG sizes: 1 s at 16 kHz, n_fft 256
CLI_SIZES = dict(audio_seconds=1, n_fft=256)
SAMPLES = 16000


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("hw", [(2, 2), (9, 11), (7, 7)])
def test_adaptive_pool_matches_jax(hw):
    x = np.random.default_rng(sum(hw)).standard_normal(
        (2, *hw, 5)).astype(np.float32)
    want = np.asarray(adaptive_avg_pool_2d(jnp.asarray(x), 7, 7))
    got = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


def test_vgg11_bn_logits_match_jax():
    x = (np.random.default_rng(0).standard_normal((2, 64, 64, 3)) * 0.5
         ).astype(np.float32)
    jm = JaxVGG11BN(10)
    variables = random_variables(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(VGG11BN(10), variables).eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_seeded_init_fills_conv2d_from_the_seed():
    """Conv2d takes its weights from the seed, not torch's global RNG."""
    outs = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        outs.append(seeded_init_(Conv2d(3, 4, 3, padding=1), seed=3))
    assert torch.equal(outs[0].weight, outs[1].weight)
    assert torch.equal(outs[0].bias, outs[1].bias)
    assert outs[0].weight.abs().max() <= 27 ** -0.5


def _labelled(n=2, seed=3):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((n, SAMPLES)) * 0.1).astype(np.float32)
    mask = np.ones(n, np.float32)
    return {"modalities": {"audio": {"data": wav, "present": mask}},
            "labels": {"main": np.arange(n, dtype=np.int32) % 2},
            "label_mask": {"main": mask}, "sample_mask": mask}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def reference():
    """(variables, batch, JAX logits, loss, gradients) of the JAX
    SpectrogramVGG at the CLI test's sizes, deterministic."""
    cfg = jcli.AudioTransformerConfig(**CLI_SIZES)
    jmodel = jcli.make_model(cfg)
    b = _labelled()
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["modalities"]), seed=2)
    specs = {"main": JaxLossSpec("ce")}

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           b["modalities"], train=False)
        return _head_losses_and_metrics(out, b, specs, 2)[0], out["main"]

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return (variables, b, np.asarray(logits), float(loss),
            jax.tree.map(np.asarray, grads))


def _port_model(variables):
    cfg = tcli.parse_config(tcli.AudioTransformerConfig,
                            [f"--{k}={v}" for k, v in CLI_SIZES.items()])
    return load_jax_variables(tcli.make_model(cfg), variables)


def test_spectrogram_vgg_loss_and_every_gradient_match_jax(reference):
    variables, b, want_logits, want_loss, grads = reference
    model = _port_model(variables).eval()
    assert "basis" not in model.state_dict()  # a constant, not a weight
    tb = _torch_tree(b)
    out = model(tb["modalities"])
    np.testing.assert_allclose(out["main"].detach().numpy(), want_logits,
                               atol=1e-4 * np.abs(want_logits).max(),
                               rtol=1e-4)
    total, _ = head_losses_and_metrics(out, tb, {"main": LossSpec("ce")}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), want_loss, atol=1e-5, rtol=1e-5)
    want = from_jax_variables({"params": grads})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want) and len(named) == 2 * 8 * 2 + 6
    for name, p in named.items():
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        assert p.grad is not None and scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_train_step_lowers_the_loss_and_moves_bn_statistics(reference):
    variables, b, _, _, _ = reference
    state = create_train_state(_port_model(variables),
                               OptimizerConfig(learning_rate=1e-4), "cpu")
    bn = state.model.vgg.bn0
    mean0 = bn.running_mean.clone()
    tb = _torch_tree(b)
    losses = []
    for _ in range(2):  # the same masks and dropout draws both times
        set_generator(state.model, torch.Generator().manual_seed(3))
        losses.append(train_step(state, tb, {"main": LossSpec("ce")},
                                 2)["total_loss"].item())
    assert state.step == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    assert not torch.equal(bn.running_mean, mean0)


def _cli_args(tmp_path, *extra):
    args = ["--files_root", str(tmp_path / "wavs"), "--synthetic_wav",
            "--saving_dir", str(tmp_path / "runs"), "--run_name", "r",
            "--epoch_num", "1", "--batch_size", "2", "--synthetic_files",
            "4", "--num_threads", "2", "--log_console", "false",
            "--device", "cpu"]
    for k, v in CLI_SIZES.items():
        args += [f"--{k}", str(v)]
    return args + list(extra)


def test_cli_trains_and_writes_logs_and_checkpoints(tmp_path):
    trainer = tcli.main(_cli_args(tmp_path))
    try:
        files = set(os.listdir(trainer.run_dir))
        assert {"checkpoint_current", "checkpoint_best_main", "config.json",
                "main_train_log.csv", "main_test_log.csv"} <= files
        for split in ("train", "test"):
            df = pd.read_csv(os.path.join(trainer.run_dir,
                                          f"main_{split}_log.csv"))
            assert df["epoch"].tolist() == [0]
            assert np.isfinite(df["loss"]).all() and "UAR" in df
        cfg = json.load(open(os.path.join(trainer.run_dir, "config.json")))
        assert (cfg["arch"], cfg["n_fft"], cfg["device"]) == ("vgg", 256,
                                                              "cpu")
        assert trainer.state.step == 2  # 4 train wavs at b2
        assert sorted(os.listdir(tmp_path / "wavs" / "train")) == [
            "clip0_NOAGGR.wav", "clip1_AGGR.wav", "clip2_NOAGGR.wav",
            "clip3_AGGR.wav"]
    finally:  # two VGG11 checkpoints with Adam state are ~3 GB
        shutil.rmtree(trainer.run_dir)


def test_cli_transformer_arch_is_a_later_slice(tmp_path):
    """`--arch transformer` arrived with the wav2vec slice: it trains on
    the CPU and writes the head 'main''s logs and checkpoints
    (tests/test_torch_w2v_transformer.py holds its model to JAX's); an
    unknown arch still fails before any data work."""
    with pytest.raises(SystemExit, match="--arch must be vgg or transformer"):
        tcli.main(_cli_args(tmp_path, "--arch", "lstm"))
    assert not (tmp_path / "wavs").exists()
    trainer = tcli.main(_cli_args(tmp_path, "--arch", "transformer"))
    files = set(os.listdir(trainer.run_dir))
    assert {"checkpoint_current", "checkpoint_best_main",
            "main_train_log.csv", "main_test_log.csv"} <= files
    df = pd.read_csv(os.path.join(trainer.run_dir, "main_train_log.csv"))
    assert df["epoch"].tolist() == [0] and np.isfinite(df["loss"]).all()
    assert trainer.state.step == 2
    assert isinstance(trainer.state.model, tcli.W2VTransformer)


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = [a for a in _cli_args(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
    assert not (tmp_path / "wavs").exists()  # failed before any data work
