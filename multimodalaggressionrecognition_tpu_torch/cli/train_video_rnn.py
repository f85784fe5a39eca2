"""Video feature-sequence RNN training (the JAX package's
cli/train_video_rnn.py).

Precomputed per-clip feature sequences (`*_LABEL.npy`, (T, feature_dim):
19 x 512 for the reference's 304 frames in 16-frame windows) -> three heads
trained together on CE, each with its own log and `checkpoint_best_<head>`:
`LSTM_1_layer`, `GRU_1_layer` and `Avg`.  No kernel runs.  Runs on CUDA
unless --device cpu.

The train root is `train/0/` when it exists, else `train/`;
`--epoch_dirs` moves it to `train/<epoch>/` at the start of each epoch
that has one (the reference's pre-augmented feature directories).

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_video_rnn \\
      --files_root feats --synthetic_features
"""

import os
from dataclasses import dataclass

from .common import (NamesPinConfig, build_trainer, parse_config,
                     pinned_files, run_training)
from .train_audio_rnn import HEADS


@dataclass
class VideoRnnConfig(NamesPinConfig):
    model_name: str = "video_rnn"
    files_root: str = ""           # dir with train[/epoch]/ and test/ .npy
    hidden_size: int = 512
    feature_dim: int = 512
    sequence_len: int = 19         # feature tokens per clip (export only;
                                   # 304 frames / 16-frame windows)
    epoch_dirs: bool = False       # advance train/<epoch>/ each epoch
    synthetic_features: bool = False


def make_model(cfg):
    from ..models.heads import FeatureSequenceProcessing, MultiHeadModel
    from ..train.steps import MultiHeadAdapter

    width = cfg.feature_dim
    return MultiHeadAdapter(MultiHeadModel({
        "LSTM_1_layer": FeatureSequenceProcessing(
            2, cfg.hidden_size, "lstm", input_size=width),
        "GRU_1_layer": FeatureSequenceProcessing(
            2, cfg.hidden_size, "gru", input_size=width),
        "Avg": FeatureSequenceProcessing(2, width, "avg", input_size=width),
    }), "video")


def make_loaders(cfg):
    """([train loader, test loader], the train source)."""
    from ..data.files import FilenameLabelSource, RandomBatchSampler
    from ..data.pipeline import BatchLoader

    if cfg.synthetic_features and not os.path.isdir(
            os.path.join(cfg.files_root, "test")):
        from ..data.synthetic import make_synthetic_features

        make_synthetic_features(cfg.files_root, cfg.feature_dim)
    train_root = os.path.join(cfg.files_root, "train")
    if os.path.isdir(os.path.join(train_root, "0")):
        train_root = os.path.join(train_root, "0")
    sources, loaders = [], []
    for root, shuffle, sub in ((train_root, True, "train"),
                               (os.path.join(cfg.files_root, "test"), False,
                                "test")):
        src = FilenameLabelSource(root, "video", heads=HEADS,
                                  files=pinned_files(cfg, sub))
        sampler = RandomBatchSampler(len(src), cfg.batch_size, shuffle,
                                     cfg.seed)
        sources.append(src)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders, sources[0]


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(VideoRnnConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    model = seeded_init_(make_model(cfg), cfg.seed)
    (train_loader, test_loader), train_src = make_loaders(cfg)

    on_epoch_start = None
    if cfg.epoch_dirs:
        base = os.path.join(cfg.files_root, "train")

        def on_epoch_start(epoch):
            path = os.path.join(base, str(epoch))
            if os.path.isdir(path):
                train_src.set_root(path)

    trainer = build_trainer(cfg, model, {h: LossSpec("ce") for h in HEADS},
                            train_loader, test_loader,
                            on_epoch_start=on_epoch_start)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py): the
    precomputed feature sequences are (sequence_len, feature_dim), 19
    tokens for the reference's 304 frames in 16-frame windows."""
    return {"video": (cfg.sequence_len, cfg.feature_dim)}


if __name__ == "__main__":
    main()
