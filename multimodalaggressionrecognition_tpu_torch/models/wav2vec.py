"""Wav2vec-family audio feature encoders (the JAX package's models/wav2vec.py).

- `ConvFeatureEncoder`: wav2vec-2's strided conv stack, (B, L) waveform ->
  (B, T, C) features, the exact GELU after each conv, a GroupNorm with one
  group per channel after conv0 ('group_norm') or a LayerNorm after every
  conv ('layer_norm');
- `Wav2Vec2Model`: that stack, the feature projection, the grouped-conv
  positional embedding and a GELU transformer (post-LN, or pre-LN for the
  large HuBERTs and XLS-R), returning the last layer's output;
- `Wav2Vec2ExtractorWrapper`: a `Wav2Vec2Model` as the multimodal model's
  audio tower, its output adapted to the fusion width;
- `Wav2Vec1ConvEncoder`: the public wav2vec-1 conv encoder (512-d), each
  conv followed by a one-group GroupNorm and ReLU.

The convs are bias-free unless the config says otherwise, so conv0 (C_in
1) is `F.conv1d`, as XLA's framed matmul is in the JAX package
(models/nn1d.py); with a bias (the large HuBERTs, XLS-R) conv0 is the
framed-conv kernel.  Weights come from seeded init or the JAX bridge
(io/from_jax.py); torchaudio's and HuggingFace's pretrained weights are
not imported.

`XLSR_300M` is XLS-R 300M (Babu et al., arXiv:2111.09296; HuggingFace
`facebook/wav2vec2-xls-r-300m`) as it is fine-tuned, a `FineTuneConfig`:
HuBERT-large's geometry with separate dropout rates (attention, hidden and
feature projection 0.1, activation 0.0), a weight-normed positional conv,
time masking (SpecAugment) and the conv feature encoder frozen.  Its LayerDrop
(0.1 as published) is not ported: every step runs all 24 layers.  Under
bf16 compute the norms run in f32 (`layers.LayerNorm`) and the attention's
scores and softmax too, as in the port's other transformer layers.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.erf import gelu
from ..utils.profiling import backward_mark, span
from .layers import LayerNorm, Linear, TransformerEncoderLayer
from .nn1d import Conv1d, GroupNorm
from .stochastic import Dropout, Random


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2))
    extractor_mode: str = "group_norm"  # 'group_norm' | 'layer_norm'
    conv_bias: bool = False
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ff_dim: int = 3072
    dropout: float = 0.1
    layer_norm_first: bool = False
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16

    def frames(self, samples: int) -> int:
        """The conv stack's output frames for `samples` samples."""
        for _, k, s in self.conv_layers:
            samples = (samples - k) // s + 1
        return samples


@dataclass(frozen=True)
class FineTuneConfig(Wav2Vec2Config):
    """A wav2vec-2 model as it is fine-tuned (HF `Wav2Vec2Config`'s names).
    A `Wav2Vec2Config` (the presets, the JAX package's) runs as the
    defaults here do: every dropout at `dropout`, a plain positional conv,
    no time mask, the conv encoder trained."""
    # the separate dropout rates; None takes `dropout`
    attention_dropout: Optional[float] = None
    hidden_dropout: Optional[float] = None
    feat_proj_dropout: Optional[float] = None
    activation_dropout: Optional[float] = None
    # the positional conv's weight as weight_g * weight_v / |weight_v|, the
    # norm over all but the kernel axis (torch's weight_norm, dim 2)
    pos_conv_weight_norm: bool = False
    # time masking in training: spans of `mask_time_length` frames replaced
    # by the learned `masked_spec_embed`; 0 leaves it out
    mask_time_prob: float = 0.0
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    # no gradient into the conv feature encoder, whose leaves are frozen
    freeze_feature_encoder: bool = False


def fine_tuning(config, name: str):
    """Option `name` of `FineTuneConfig` as `config` (any wav2vec-2
    config) sets it, a dropout rate resolved to `dropout`."""
    value = getattr(config, name,
                    getattr(FineTuneConfig, name, None))
    if value is None and name.endswith("_dropout"):
        return config.dropout
    return value


WAV2VEC2_BASE = Wav2Vec2Config()
HUBERT_BASE = Wav2Vec2Config()
HUBERT_LARGE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_bias=True, embed_dim=1024,
    num_layers=24, num_heads=16, ff_dim=4096, layer_norm_first=True)
HUBERT_XLARGE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_bias=True, embed_dim=1280,
    num_layers=48, num_heads=16, ff_dim=5120, layer_norm_first=True)
XLSR_300M = FineTuneConfig(
    extractor_mode="layer_norm", conv_bias=True, embed_dim=1024,
    num_layers=24, num_heads=16, ff_dim=4096, layer_norm_first=True,
    attention_dropout=0.1, hidden_dropout=0.1, feat_proj_dropout=0.1,
    activation_dropout=0.0, pos_conv_weight_norm=True, mask_time_prob=0.075,
    freeze_feature_encoder=True)

# the public fairseq wav2vec-1 conv encoder: (features, kernel, stride)
WAV2VEC1_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2))


class ConvFeatureEncoder(nn.Module):
    """Strided conv stack: (B, L) or (B, L, 1) -> (B, T, C), GELU acts."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] =
                 WAV2VEC2_BASE.conv_layers, mode: str = "group_norm",
                 use_bias: bool = False):
        super().__init__()
        if mode not in ("group_norm", "layer_norm"):
            raise ValueError(f"mode must be 'group_norm' or 'layer_norm', "
                             f"got {mode!r}")
        self.num_convs = len(conv_layers)
        c_in = 1
        for i, (feats, k, s) in enumerate(conv_layers):
            self.add_module(f"conv{i}",
                            Conv1d(c_in, feats, k, s, bias=use_bias))
            if mode == "group_norm" and i == 0:
                self.add_module(f"norm{i}", GroupNorm(feats, feats))
            elif mode == "layer_norm":
                self.add_module(f"norm{i}", LayerNorm(feats, eps=1e-5))
            c_in = feats

    def forward(self, x):
        if x.dim() == 2:
            x = x[..., None]
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
            norm = getattr(self, f"norm{i}", None)
            if norm is not None:
                x = norm(x)
            x = gelu(x, "erf")
        return x


class ConvPositionalEmbedding(nn.Module):
    """Grouped Conv1d positional embedding (k 128, 16 groups, padding k/2)
    + GELU on (B, T, E).  An even kernel gives T + 1 frames, and the last
    is dropped.  Weight (E, E/groups, K) as torch's; `weight_norm` holds it
    as `weight_g` (1, 1, K) and `weight_v` (E, E/groups, K), the weight
    being g * v / |v| with the norm over all but the kernel axis, computed
    in f32 under any compute dtype."""

    def __init__(self, embed_dim: int, kernel: int = 128, groups: int = 16,
                 weight_norm: bool = False):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight_norm = weight_norm
        shape = (embed_dim, embed_dim // groups, kernel)
        weight = torch.empty(shape)
        nn.init.normal_(weight, std=(4.0 / (kernel * embed_dim)) ** 0.5)
        if weight_norm:
            self.weight_v = nn.Parameter(weight)
            self.weight_g = nn.Parameter(weight_norm_of(weight))
        else:
            self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def conv_weight(self, dtype):
        """The conv's weight in `dtype`."""
        if not self.weight_norm:
            return self.weight.to(dtype)
        v = self.weight_v.float()
        return (self.weight_g.float() * v / weight_norm_of(v)).to(dtype)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.conv_weight(x.dtype),
                     self.bias.to(x.dtype),
                     padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[:, :, :-1]
        return gelu(y.transpose(1, 2), "erf")


def weight_norm_of(v):
    """|v| over all but the last (kernel) axis, (1, 1, K)."""
    return torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)


def mask_time_spans(u, keys, prob: float, length: int, min_masks: int):
    """(B, T) bool: the frames time masking replaces, from one clip's
    uniforms `u` (B,) and `keys` (B, T - length + 1), as HF's
    `_compute_mask_indices` draws them: floor(prob * T / length + u) spans
    (at least `min_masks`, at most what the frames hold), each `length`
    frames long, their starts distinct and uniform over [0, T - length]:
    the positions of the largest keys, the lower position first among
    equal keys.  Spans may overlap.  On the device, with no readback."""
    b, starts = keys.shape
    frames = starts + length - 1
    most = max_time_spans(prob, length, min_masks, frames)
    count = torch.floor(prob * frames / length + u).clamp(min=min_masks,
                                                          max=most)
    first = torch.argsort(keys, dim=-1, descending=True,
                          stable=True)[:, :most]
    used = torch.arange(most, device=keys.device) < count[:, None]
    t = torch.arange(frames, device=keys.device)
    inside = ((t >= first[..., None]) & (t < first[..., None] + length)
              & used[..., None])
    return inside.any(dim=1)


def max_time_spans(prob: float, length: int, min_masks: int,
                   frames: int) -> int:
    """The most spans a clip of `frames` frames draws."""
    return min(max(min_masks, math.ceil(prob * frames / length)),
               frames // length, frames - length + 1)


class TimeMask(Random):
    """SpecAugment's time masking in training (HF wav2vec-2's
    `_mask_hidden_states`, mask_time_selection "static"): each clip's
    spans (`mask_time_spans`) take the learned embedding in place of the
    features.  It draws a clip's uniforms, then its keys."""

    def __init__(self, prob: float, length: int, min_masks: int):
        super().__init__()
        self.prob, self.length, self.min_masks = prob, length, min_masks

    def forward(self, h, embed):
        if not self.training:
            return h
        b, t, _ = h.shape
        u = self.draw((b,), h.device)
        keys = self.draw((b, t - self.length + 1), h.device)
        mask = mask_time_spans(u, keys, self.prob, self.length,
                               self.min_masks)
        return torch.where(mask[..., None], embed.to(h.dtype), h)


class Wav2Vec2Model(nn.Module):
    """Conv encoder + feature projection + transformer: (B, L) -> the last
    transformer layer's output (B, T, E), the tensor the reference's
    wav2vec-2 extractor gave (`extract_features(x)[0][-1]`).

    `num_outputs` runs only the first that many layers, as torchaudio's
    num_layers; the pre-LN models' final `encoder_norm` applies on the full
    forward only (HF's last_hidden_state), never after a truncated stack.

    The order of the draws in training: the feature projection's dropout,
    the time mask, the dropout after the positional embedding, then each
    layer's.  Spans (utils/profiling.py): `forward.audio.features` (the
    conv encoder), `forward.audio.pos_conv`, and the backward split at the
    positional conv's output (`backward.audio.pos_conv`) and at the
    projected features (`backward.audio.projection`)."""

    def __init__(self, config: Wav2Vec2Config = WAV2VEC2_BASE):
        super().__init__()
        cfg = self.config = config
        e = cfg.embed_dim
        self.frozen = fine_tuning(cfg, "freeze_feature_encoder")
        self.feature_extractor = ConvFeatureEncoder(
            cfg.conv_layers, cfg.extractor_mode, cfg.conv_bias)
        if self.frozen:
            self.feature_extractor.requires_grad_(False)
        width = cfg.conv_layers[-1][0]
        self.fp_norm = LayerNorm(width, eps=1e-5)
        self.fp_proj = Linear(width, e)
        self.fp_dropout = Dropout(fine_tuning(cfg, "feat_proj_dropout"))
        self.time_mask = None
        if fine_tuning(cfg, "mask_time_prob") > 0:
            self.masked_spec_embed = nn.Parameter(torch.empty(e).uniform_())
            self.time_mask = TimeMask(cfg.mask_time_prob,
                                      cfg.mask_time_length,
                                      cfg.mask_time_min_masks)
        self.dropout = Dropout(fine_tuning(cfg, "hidden_dropout"))
        self.pos_conv = ConvPositionalEmbedding(
            e, cfg.pos_conv_kernel, cfg.pos_conv_groups,
            fine_tuning(cfg, "pos_conv_weight_norm"))
        self.encoder_norm = LayerNorm(e, eps=1e-5)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                e, cfg.num_heads, cfg.ff_dim,
                fine_tuning(cfg, "hidden_dropout"), activation="gelu",
                norm_first=cfg.layer_norm_first,
                attention_dropout=fine_tuning(cfg, "attention_dropout"),
                activation_dropout=fine_tuning(cfg, "activation_dropout"))
            for _ in range(cfg.num_layers))

    def forward(self, x, num_outputs: Optional[int] = None):
        cfg = self.config
        with span("forward.audio.features", device=True), (
                torch.no_grad() if self.frozen
                else contextlib.nullcontext()):
            feats = self.feature_extractor(x)
        h = self.fp_dropout(self.fp_proj(self.fp_norm(feats)))
        if self.time_mask is not None:
            h = self.time_mask(h, self.masked_spec_embed)
        backward_mark(h, "backward.audio.projection")
        with span("forward.audio.pos_conv", device=True):
            pos = self.pos_conv(h)
            backward_mark(pos, "backward.audio.pos_conv")
        h = h + pos
        if not cfg.layer_norm_first:
            h = self.encoder_norm(h)
        h = self.dropout(h)
        n_layers = cfg.num_layers if num_outputs is None else num_outputs
        for layer in self.layers[:n_layers]:
            h = layer(h)
        if cfg.layer_norm_first and num_outputs is None:
            h = self.encoder_norm(h)
        return h


class Wav2Vec2ExtractorWrapper(nn.Module):
    """A wav2vec-2 encoder as the multimodal model's audio tower: the
    encoder's last output, Linear(E -> hidden), ReLU, Dropout(0.3)
    (`cnn1d.AudioCnn1DExtractorWrapper`'s adaptor): (B, L) -> (B, T,
    hidden)."""

    def __init__(self, config: Wav2Vec2Config = XLSR_300M,
                 hidden_size: int = 768):
        super().__init__()
        self.encoder = Wav2Vec2Model(config)
        self.adaptor = Linear(config.embed_dim, hidden_size)
        self.dropout = Dropout(0.3)

    def forward(self, x):
        return self.dropout(torch.relu(self.adaptor(self.encoder(x))))


class Wav2Vec1ConvEncoder(nn.Module):
    """The wav2vec-1 512-d conv feature encoder (the reference's missing
    `wav2vec_feature_extractor_jit.pt`, rebuilt from the public fairseq
    design): each bias-free conv followed by a one-group GroupNorm and
    ReLU.  (B, L) -> (B, T, 512)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] =
                 WAV2VEC1_CONV_LAYERS):
        super().__init__()
        self.num_convs = len(conv_layers)
        c_in = 1
        for i, (feats, k, s) in enumerate(conv_layers):
            self.add_module(f"conv{i}", Conv1d(c_in, feats, k, s, bias=False))
            self.add_module(f"norm{i}", GroupNorm(1, feats))
            c_in = feats

    def forward(self, x):
        if x.dim() == 2:
            x = x[..., None]
        for i in range(self.num_convs):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            x = torch.relu(norm(conv(x)))
        return x
