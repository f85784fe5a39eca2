"""The audio RNN entry (cli/train_audio_rnn.py) against the JAX package's.

With the same weights carried by io/from_jax.py (strict load) and both
models deterministic (JAX `train=False`, the port in eval mode), at 1 s of
16 kHz audio and hidden 16, for the wav2vec-1, wav2vec-2-conv and CNN1D
extractors (the whole wav2vec-2 is held at a small config in
tests/test_torch_wav2vec.py): the three heads' logits within 1e-4, the
summed CE within 1e-5, and every head gradient within 1e-4 * max|g_JAX| of
that tensor, as tests/test_torch_train_step.py holds the tri-modal model's;
the frozen extractor has no gradient in the port and a zero one in JAX.
The loaders give JAX's batches, and the CLI trains on the CPU with every
extractor, writing a log pair and a best checkpoint per head.
"""

import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_audio_rnn as jcli
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_audio_rnn as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from test_torch_files import _assert_same_batches
from test_torch_rnn_heads import rnn_variables
from test_torch_train_step import torch_tree

HEADS = tcli.HEADS
SIZES = ["--hidden_size", "16", "--audio_seconds", "1"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def labelled(modality, data, heads, seed=0):
    """A batch of `data` under `modality`, every head labelled, the last row
    of each head masked."""
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    mask = np.array([1.0] * (n - 1) + [0.0], np.float32)
    return {"modalities": {modality: {"data": data,
                                      "present": np.ones(n, np.float32)}},
            "labels": {h: rng.integers(0, 2, n).astype(np.int32)
                       for h in heads},
            "label_mask": {h: mask for h in heads}}


def assert_cli_model_matches_jax(jmodel, model, b, heads, seed=1):
    """The port `model` (the JAX `jmodel`'s twin) with bridged random
    weights, eval mode: logits within 1e-4, the summed CE within 1e-5,
    every trainable gradient within 1e-4 * max|g_JAX|; a frozen parameter
    has no port gradient and a zero JAX one."""
    variables = rnn_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["modalities"]), seed)
    model = load_jax_variables(model, variables).eval()
    want_out = jax.jit(jmodel.apply)(variables, b["modalities"])
    tb = torch_tree(b)
    out = model(tb["modalities"])
    assert list(out) == list(heads)
    for h in heads:
        assert out[h].shape == (len(b["labels"][h]), 2), h
        np.testing.assert_allclose(out[h].detach().numpy(),
                                   np.asarray(want_out[h]), atol=1e-4,
                                   err_msg=h)

    specs = {h: JaxLossSpec("ce") for h in heads}
    stats = variables.get("batch_stats", {})

    def loss_fn(params):
        o = jmodel.apply({"params": params, "batch_stats": stats},
                         b["modalities"], train=False)
        return _head_losses_and_metrics(o, b, specs, 2)[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    total, _ = head_losses_and_metrics(out, tb,
                                       {h: LossSpec("ce") for h in heads}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)},
                              getattr(model, "jax_renames", ()))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    trained = 0
    for name, p in named.items():
        ref = want[name].numpy()
        if not p.requires_grad:
            assert p.grad is None and not ref.any(), name
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)
        trained += 1
    return trained


@pytest.mark.parametrize("extractor", ["wav2vec1", "wav2vec2_conv", "cnn1d"])
def test_model_logits_loss_and_gradients_match_jax(extractor):
    args = SIZES + ["--extractor", extractor]
    jmodel = jcli.make_model(jax_parse_config(jcli.AudioRnnConfig, args))
    model = tcli.make_model(parse_config(tcli.AudioRnnConfig, args))
    audio = (np.random.default_rng(2).standard_normal((3, 16000))
             * 0.1).astype(np.float32)
    trained = assert_cli_model_matches_jax(
        jmodel, model, labelled("audio", audio, HEADS), HEADS)
    assert trained == 3 * 4 + 2 * 4  # fc1, fc2 of each; 4 RNN tensors each


def test_model_widths():
    """The extractor's width feeds the RNNs and the Avg head's fc1: 768
    for the whole wav2vec-2, 512 for the others; the Avg head's hidden
    size is unused."""
    for extractor, width in (("wav2vec1", 512), ("wav2vec2_conv", 512),
                             ("cnn1d", 512)):
        model = tcli.make_model(parse_config(
            tcli.AudioRnnConfig, ["--extractor", extractor]))
        heads = model.inner.heads
        assert heads["GRU_1_layer"].sequence_nn.input_size == width
        assert heads["LSTM_1_layer"].sequence_nn.hidden_size == 512
        assert heads["Avg"].fc1.in_features == width
    extractor, width = tcli.make_extractor("wav2vec2")
    assert width == 768 == extractor.config.embed_dim
    with pytest.raises(SystemExit, match="--extractor"):
        tcli.make_extractor("hubert")


def test_loaders_give_the_jax_batches(tmp_path):
    args = ["--files_root", str(tmp_path / "wavs"), "--synthetic_wav",
            "--synthetic_tones", "--synthetic_files", "6", "--batch_size",
            "4", "--audio_seconds", "1"]
    got = tcli.make_loaders(parse_config(tcli.AudioRnnConfig, args))
    want = jcli.make_loaders(jax_parse_config(jcli.AudioRnnConfig, args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
        for batch in g:
            assert list(batch["labels"]) == list(HEADS)
            assert batch["modalities"]["audio"]["data"].shape == (4, 16000)


def check_run(trainer, heads, epochs=1):
    """A log pair and `checkpoint_best_<head>` for every head, finite
    losses, `epochs` rows a log."""
    files = set(os.listdir(trainer.run_dir))
    want = {"checkpoint_current", "config.json"}
    for h in heads:
        want |= {f"checkpoint_best_{h}", f"{h}_train_log.csv",
                 f"{h}_test_log.csv"}
    assert want <= files, sorted(want - files)
    for h in heads:
        for split in ("train", "test"):
            log = pd.read_csv(os.path.join(trainer.run_dir,
                                           f"{h}_{split}_log.csv"))
            assert log["epoch"].tolist() == list(range(epochs))
            assert np.isfinite(log["loss"]).all() and "UAR" in log


@pytest.mark.parametrize("extractor",
                         ["wav2vec1", "wav2vec2_conv", "wav2vec2", "cnn1d"])
def test_cli_trains_on_the_cpu(tmp_path, extractor):
    trainer = tcli.main([
        "--files_root", str(tmp_path / "wavs"), "--synthetic_wav",
        "--synthetic_tones", "--synthetic_files", "4", "--saving_dir",
        str(tmp_path / "runs"), "--epoch_num", "1", "--batch_size", "2",
        "--num_threads", "2", "--log_console", "false", "--device", "cpu",
        "--extractor", extractor] + SIZES)
    try:
        check_run(trainer, HEADS)
        assert trainer.state.step == 2  # 4 train wavs at b2
        ext = trainer.state.model.inner.extractor
        assert not ext.training and all(not p.requires_grad
                                        for p in ext.parameters())
    finally:  # the whole wav2vec-2's checkpoints are ~0.4 GB each
        shutil.rmtree(trainer.run_dir)


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--files_root", str(tmp_path / "wavs"), "--synthetic_wav",
                   "--saving_dir", str(tmp_path / "runs")])
    assert not (tmp_path / "wavs").exists()  # failed before any data work
