"""`--compute_dtype bfloat16` on every train entry's CLI, on the CPU.

Each entry trains one epoch at small widths on its synthetic data in bf16
(tests/test_torch_bf16_entries.py holds the models to the JAX package's
bf16): the run writes its logs and checkpoints with finite losses, saves
the flag in config.json, and leaves its master parameters and BatchNorm
statistics in f32.
"""

import importlib
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_features)

RNN_HEADS = ("LSTM_1_layer", "GRU_1_layer", "Avg")
WAVS = ["--synthetic_wav", "--synthetic_tones", "--synthetic_files", "4",
        "--batch_size", "2", "--audio_seconds", "1"]

# entry id -> (CLI module, flags beyond the common ones, heads)
ENTRIES = {
    "text": ("train_text_transformer",
             ["--synthetic", "--batch_size", "4", "--num_layers", "1"],
             ("main",)),
    "audio_vgg": ("train_audio_transformer", WAVS + ["--n_fft", "256"],
                  ("main",)),
    "audio_w2v_transformer": ("train_audio_transformer",
                              WAVS + ["--arch", "transformer"], ("main",)),
    "audio_text": ("train_audio_text",
                   ["--synthetic", "--batch_size", "4", "--audio_samples",
                    "16000", "--text_tokens", "8"], ("main",)),
    **{f"audio_rnn_{x}": ("train_audio_rnn",
                          WAVS + ["--hidden_size", "16", "--extractor", x],
                          RNN_HEADS)
       for x in ("wav2vec1", "cnn1d")},
    "video_rnn": ("train_video_rnn",
                  ["--batch_size", "2", "--hidden_size", "16",
                   "--feature_dim", "24"], RNN_HEADS),
    "video_transformer": ("train_video_transformer",
                          ["--synthetic_videos", "--synthetic_files", "4",
                           "--batch_size", "2", "--video_frames", "8",
                           "--video_size", "32", "--video_window", "4",
                           "--num_layers", "1"], ("main",)),
    "train3dcnn": ("train3dcnn",
                   ["--synthetic_clips", "--frame_num", "8", "--video_size",
                    "32", "--batch_size", "4"], ("main",)),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cli_trains_in_bf16(entry, tmp_path):
    name, flags, heads = ENTRIES[entry]
    cli = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{name}")
    data = ["--dataset_root", str(tmp_path / "ds")]
    if name == "train_video_rnn":
        make_synthetic_features(str(tmp_path / "data"), 24, n_train=4,
                                n_test=2)
    if "--synthetic" not in flags:
        data = ["--files_root", str(tmp_path / "data")]
    trainer = cli.main(data + flags + [
        "--saving_dir", str(tmp_path / "runs"), "--epoch_num", "1",
        "--num_threads", "2", "--log_console", "false", "--device", "cpu",
        "--compute_dtype", "bfloat16"])
    files = set(os.listdir(trainer.run_dir))
    for h in heads:
        assert {f"checkpoint_best_{h}", f"{h}_train_log.csv",
                f"{h}_test_log.csv"} <= files, h
        for split in ("train", "test"):
            log = pd.read_csv(os.path.join(trainer.run_dir,
                                           f"{h}_{split}_log.csv"))
            assert log["epoch"].tolist() == [0]
            assert np.isfinite(log["loss"]).all()
    cfg = json.load(open(os.path.join(trainer.run_dir, "config.json")))
    assert cfg["compute_dtype"] == "bfloat16"
    assert trainer.state.step > 0
    for t in list(trainer.state.model.parameters()) + list(
            trainer.state.model.buffers()):
        assert not t.is_floating_point() or t.dtype == torch.float32
    # the checkpoints (~3 GB for the full-width VGG) once checked
    shutil.rmtree(trainer.run_dir)
