"""Audio training on spectrograms or wav2vec features (the JAX package's
cli/train_audio_transformer.py).

`--arch vgg` (the default and the reference's live path): a flat directory
of `*_LABEL.wav` clips (resampled to 16 kHz and padded to `audio_seconds`
on the host) -> a power spectrogram on the device, the STFT
through the framed-conv kernel (n_fft 512: 257 bins x 313 frames for 5 s)
-> in train mode one frequency and one time mask per batch -> the
spectrogram repeated into 3 channels -> VGG11-BN -> CE on the single head
'main', Adam and best-UAR checkpoints.  Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_audio_transformer \
      --files_root wavs --synthetic_wav --synthetic_tones

`--arch transformer` (the reference's commented-out alternative): the
frozen wav2vec-1 conv encoder (no gradient; 5 s -> 498 frames x 512) -> a
2-layer, 8-head transformer encoder, mean-pooled, and an MLP -> CE on
'main'.  No kernel runs: the encoder's bias-free conv0 is `F.conv1d`.
"""

import os
from dataclasses import dataclass

from torch import nn

from ..models.heads import MultiHeadModel, TransformerSequenceClassifier
from ..models.stochastic import Random
from ..models.vgg import VGG11BN
from ..models.wav2vec import Wav2Vec1ConvEncoder
from ..ops.stft import dft_basis, freq_mask, spectrogram, time_mask
from .common import (NamesPinConfig, build_trainer, parse_config,
                     pinned_files, run_training)


@dataclass
class AudioTransformerConfig(NamesPinConfig):
    model_name: str = "audio_vgg"
    files_root: str = ""
    arch: str = "vgg"              # vgg | transformer
    audio_seconds: int = 5
    sample_rate: int = 16000
    n_fft: int = 512
    freq_mask: int = 80
    time_mask: int = 80
    hidden_size: int = 512
    synthetic_wav: bool = False
    synthetic_files: int = 32          # train wavs in the fixture (test n/4)
    synthetic_tones: bool = False      # class-coded tones


class SpectrogramMasks(Random):
    """In train mode one frequency mask then one time mask on (B, F, T),
    each drawn once for the batch from the module's generator; the identity
    in eval mode."""

    def __init__(self, freq_param: int, time_param: int):
        super().__init__()
        self.freq_param, self.time_param = freq_param, time_param

    def forward(self, spec):
        if not self.training:
            return spec
        spec = freq_mask(spec, self.freq_param, self.generator)
        return time_mask(spec, self.time_param, self.generator)


class SpectrogramVGG(nn.Module):
    """Waveform (B, L) -> {'main': logits (B, 2)}: the spectrogram, the
    masks in train mode, three identical channels, VGG11-BN.  The DFT basis
    is a constant (a buffer kept out of the state_dict, as the JAX model has
    no leaf for it); no gradient reaches the spectrogram of the data, so
    the framed conv runs forward only."""

    def __init__(self, n_fft: int = 512, freq_param: int = 80,
                 time_param: int = 80):
        super().__init__()
        self.n_fft = n_fft
        self.register_buffer("basis", dft_basis(n_fft), persistent=False)
        self.masks = SpectrogramMasks(freq_param, time_param)
        self.vgg = VGG11BN(class_num=2)

    def forward(self, modalities):
        spec = spectrogram(modalities["audio"]["data"], n_fft=self.n_fft,
                           basis=self.basis)  # (B, F, T)
        img = self.masks(spec)[:, None].expand(-1, 3, -1, -1)
        return {"main": self.vgg(img)}


class W2VTransformer(MultiHeadModel):
    """Waveform (B, L) -> {'main': logits (B, 2)}: the frozen wav2vec-1
    conv encoder (no gradient, eval mode), then a
    TransformerSequenceClassifier, the single head 'main'."""

    # flax names the classifier `head`, beside the root's `extractor`
    jax_renames = (("head.", "heads.main."),)

    def __init__(self, hidden_size: int):
        super().__init__({"main": TransformerSequenceClassifier(
            class_num=2, hidden_size=hidden_size, num_layers=2, num_heads=8)},
            Wav2Vec1ConvEncoder())

    def forward(self, modalities):
        return super().forward(modalities["audio"]["data"])


def make_model(cfg):
    if cfg.arch == "vgg":
        return SpectrogramVGG(cfg.n_fft, cfg.freq_mask, cfg.time_mask)
    if cfg.arch == "transformer":
        return W2VTransformer(cfg.hidden_size)
    raise SystemExit(f"--arch must be vgg or transformer, got {cfg.arch!r}")


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
                                  target_rate=cfg.sample_rate,
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

    cfg = parse_config(AudioTransformerConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    model = seeded_init_(make_model(cfg), cfg.seed)
    train_loader, test_loader = make_loaders(cfg)
    trainer = build_trainer(cfg, model, {"main": LossSpec("ce")},
                            train_loader, test_loader)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py)."""
    return {"audio": (cfg.sample_rate * cfg.audio_seconds,)}


if __name__ == "__main__":
    main()
