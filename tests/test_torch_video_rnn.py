"""The video feature-sequence RNN entry (cli/train_video_rnn.py) against the
JAX package's.

With the same weights carried by io/from_jax.py and both models
deterministic, at 19 x 24 feature sequences and hidden 16: the three
heads' logits within 1e-4, the summed CE within 1e-5 and every gradient
within 1e-4 * max|g_JAX| of that tensor.  The synthetic feature fixture is
byte-equal to JAX's, the loaders give JAX's batches (`train/0/` taken as
the train root), the trainer calls `on_epoch_start` before the sampler's
`set_epoch`, and the CLI trains on the CPU with and without
`--epoch_dirs`, which moves the train source to `train/<epoch>/`.
"""

import os

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_video_rnn as jcli
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_video_rnn as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_features)
from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig)
from test_torch_audio_rnn import (HEADS, assert_cli_model_matches_jax,
                                  check_run, labelled)
from test_torch_files import _assert_same_batches

SIZES = ["--hidden_size", "16", "--feature_dim", "24"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_model_logits_loss_and_gradients_match_jax():
    jmodel = jcli.make_model(jax_parse_config(jcli.VideoRnnConfig, SIZES))
    model = tcli.make_model(parse_config(tcli.VideoRnnConfig, SIZES))
    feats = np.random.default_rng(3).standard_normal((3, 19, 24)).astype(
        np.float32)
    trained = assert_cli_model_matches_jax(
        jmodel, model, labelled("video", feats, HEADS), HEADS)
    assert trained == 3 * 4 + 2 * 4
    assert model.inner.heads["Avg"].fc1.in_features == 24


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, files in os.walk(root) for f in files}


def test_synthetic_features_are_byte_equal_to_jax(tmp_path):
    jcli._make_synthetic_features(str(tmp_path / "jax"), 24, n_train=4,
                                  n_test=2)
    make_synthetic_features(str(tmp_path / "port"), 24, n_train=4, n_test=2)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) == sorted(
        [f"train/0/clip{i}_{'AGGR' if i % 2 else 'NOAGGR'}.npy"
         for i in range(4)]
        + [f"test/clip{i}_{'AGGR' if i % 2 else 'NOAGGR'}.npy"
           for i in range(2)])
    assert got == want
    assert np.load(tmp_path / "port/test/clip1_AGGR.npy").shape == (19, 24)


def test_loaders_give_the_jax_batches(tmp_path):
    args = ["--files_root", str(tmp_path / "feats"), "--synthetic_features",
            "--batch_size", "8"] + SIZES
    (got, src) = tcli.make_loaders(parse_config(tcli.VideoRnnConfig, args))
    (want, jsrc) = jcli.make_loaders(jax_parse_config(jcli.VideoRnnConfig,
                                                      args))
    assert src.root == jsrc.root == str(tmp_path / "feats" / "train" / "0")
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
        for batch in g:
            assert list(batch["labels"]) == list(HEADS)
            assert batch["modalities"]["video"]["data"].shape == (8, 19, 24)


class _Recorder:
    """A loader stand-in whose sampler logs `set_epoch` into `calls`."""

    def __init__(self, calls):
        self.calls = calls
        self.sampler = self

    def set_epoch(self, epoch):
        self.calls.append(("set_epoch", epoch))


def test_on_epoch_start_runs_before_the_samplers_epoch(tmp_path):
    calls = []
    trainer = Trainer(torch.nn.Linear(1, 1), {},
                      OptimizerConfig(learning_rate=1e-3), _Recorder(calls),
                      None, num_classes=2, saving_dir=str(tmp_path),
                      model_name="m", device="cpu", log_console=False,
                      on_epoch_start=lambda e: calls.append(("start", e)))
    trainer.train_epoch = lambda generator: {}
    trainer.eval_epoch = lambda: {}
    trainer.save_checkpoint = lambda epoch: None
    trainer.fit(2)
    assert calls == [("start", 0), ("set_epoch", 0), ("start", 1),
                     ("set_epoch", 1)]


@pytest.mark.parametrize("epoch_dirs", [False, True])
def test_cli_trains_on_the_cpu(tmp_path, epoch_dirs):
    root = tmp_path / "feats"
    make_synthetic_features(str(root), 24, n_train=4, n_test=2)
    if epoch_dirs:  # epoch 1's directory: the same names, other features
        os.makedirs(root / "train" / "1")
        for name in os.listdir(root / "train" / "0"):
            np.save(root / "train" / "1" / name,
                    np.zeros((19, 24), np.float32))
    args = ["--files_root", str(root), "--saving_dir", str(tmp_path / "runs"),
            "--epoch_num", "2", "--batch_size", "2", "--num_threads", "2",
            "--log_console", "false", "--device", "cpu"] + SIZES
    if epoch_dirs:
        args.append("--epoch_dirs")
    trainer = tcli.main(args)
    check_run(trainer, HEADS, epochs=2)
    want_root = root / "train" / ("1" if epoch_dirs else "0")
    assert trainer.train_loader.source.root == str(want_root)
    assert trainer.state.step == 4


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--files_root", str(tmp_path / "feats"),
                   "--synthetic_features", "--saving_dir",
                   str(tmp_path / "runs")])
    assert not (tmp_path / "feats").exists()  # failed before any data work
