"""Audio RNN multi-head training (the JAX package's cli/train_audio_rnn.py).

A flat directory of `*_LABEL.wav` clips (resampled to 16 kHz and padded to
`audio_seconds` on the host) -> a frozen audio feature extractor (no
gradient, eval mode) -> three heads trained together on CE, each with its
own log and `checkpoint_best_<head>`: `LSTM_1_layer`, `GRU_1_layer` and
`Avg` (the mean over time).  Runs on CUDA unless --device cpu.

`--extractor`:
- `wav2vec1` (default): the wav2vec-1 conv encoder, 512-d (10 s -> 998
  frames);
- `wav2vec2_conv`: wav2vec-2's conv stack, 512-d (499 frames);
- `wav2vec2`: the whole wav2vec-2 base model, 768-d (499 frames);
- `cnn1d`: the CNN1D trunk, 512-d, whose stem runs the framed-conv kernel
  with its BatchNorm and ReLU folded in, once per step.
The weights are seeded (the reference's pretrained extractors are not in
the repository).  The JAX entry's `--pallas_stem` is not carried over: on
CUDA the stem always runs the kernel.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_audio_rnn \\
      --files_root wavs --synthetic_wav --synthetic_tones
"""

import os
from dataclasses import dataclass

from .common import (NamesPinConfig, build_trainer, parse_config,
                     pinned_files, run_training)

HEADS = ("LSTM_1_layer", "GRU_1_layer", "Avg")


@dataclass
class AudioRnnConfig(NamesPinConfig):
    model_name: str = "audio_rnn"
    files_root: str = ""               # dir with train/ and test/ wavs
    # wav2vec1 | wav2vec2_conv | wav2vec2 | cnn1d
    extractor: str = "wav2vec1"
    hidden_size: int = 512
    audio_seconds: int = 10
    sample_rate: int = 16000
    synthetic_wav: bool = False        # generate a flat synthetic wav tree
    synthetic_files: int = 32          # train wavs in the fixture (test n/4)
    synthetic_tones: bool = False      # class-coded tones


def make_extractor(name: str):
    """(frozen-to-be extractor, its feature width)."""
    from ..models.cnn1d import CNN1DExtractor
    from ..models.wav2vec import (WAV2VEC2_BASE, ConvFeatureEncoder,
                                  Wav2Vec1ConvEncoder, Wav2Vec2Model)

    if name == "wav2vec1":
        return Wav2Vec1ConvEncoder(), 512
    if name == "wav2vec2_conv":
        return ConvFeatureEncoder(), 512
    if name == "wav2vec2":
        return Wav2Vec2Model(WAV2VEC2_BASE), WAV2VEC2_BASE.embed_dim
    if name == "cnn1d":
        return CNN1DExtractor(), 512
    raise SystemExit(f"--extractor must be wav2vec1, wav2vec2_conv, wav2vec2 "
                     f"or cnn1d, got {name!r}")


def make_model(cfg):
    from ..models.heads import FeatureSequenceProcessing, MultiHeadModel
    from ..train.steps import MultiHeadAdapter

    extractor, width = make_extractor(cfg.extractor)
    heads = {
        "LSTM_1_layer": FeatureSequenceProcessing(
            2, cfg.hidden_size, "lstm", input_size=width),
        "GRU_1_layer": FeatureSequenceProcessing(
            2, cfg.hidden_size, "gru", input_size=width),
        "Avg": FeatureSequenceProcessing(2, 512, "avg", input_size=width),
    }
    return MultiHeadAdapter(MultiHeadModel(heads, extractor), "audio")


def make_loaders(cfg):
    from ..data.files import FilenameLabelSource, RandomBatchSampler
    from ..data.pipeline import BatchLoader
    from ..data.transforms import pad_audio

    if cfg.synthetic_wav and not os.path.isdir(
            os.path.join(cfg.files_root, "train")):
        from ..data.synthetic import make_synthetic_wavs

        n = cfg.synthetic_files
        make_synthetic_wavs(cfg.files_root, cfg.sample_rate, n_train=n,
                            n_test=max(2, n // 4), tones=cfg.synthetic_tones)
    target = cfg.sample_rate * cfg.audio_seconds
    loaders = []
    for sub, shuffle in (("train", True), ("test", False)):
        src = FilenameLabelSource(os.path.join(cfg.files_root, sub), "audio",
                                  transform=pad_audio(target),
                                  target_rate=cfg.sample_rate, heads=HEADS,
                                  files=pinned_files(cfg, sub))
        sampler = RandomBatchSampler(len(src), cfg.batch_size, shuffle,
                                     cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(AudioRnnConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    model = seeded_init_(make_model(cfg), cfg.seed)
    train_loader, test_loader = make_loaders(cfg)
    trainer = build_trainer(cfg, model, {h: LossSpec("ce") for h in HEADS},
                            train_loader, test_loader)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py)."""
    return {"audio": (cfg.sample_rate * cfg.audio_seconds,)}


if __name__ == "__main__":
    main()
