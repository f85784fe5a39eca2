"""Wav2vec-family audio feature encoders (the JAX package's models/wav2vec.py).

- `ConvFeatureEncoder`: wav2vec-2's strided conv stack, (B, L) waveform ->
  (B, T, C) features, the exact GELU after each conv, a GroupNorm with one
  group per channel after conv0 ('group_norm') or a LayerNorm after every
  conv ('layer_norm');
- `Wav2Vec2Model`: that stack, the feature projection, the grouped-conv
  positional embedding and a GELU transformer (post-LN, or pre-LN for the
  large HuBERTs), returning the last layer's output;
- `Wav2Vec1ConvEncoder`: the public wav2vec-1 conv encoder (512-d), each
  conv followed by a one-group GroupNorm and ReLU.

The convs are bias-free unless the config says otherwise, so conv0 (C_in
1) is `F.conv1d`, as XLA's framed matmul is in the JAX package
(models/nn1d.py).  Weights come from seeded init or the JAX bridge
(io/from_jax.py); torchaudio's and HuggingFace's pretrained weights are
not imported.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.erf import gelu
from .layers import Linear, TransformerEncoderLayer
from .nn1d import Conv1d, GroupNorm
from .stochastic import Dropout


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


WAV2VEC2_BASE = Wav2Vec2Config()
HUBERT_BASE = Wav2Vec2Config()
HUBERT_LARGE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_bias=True, embed_dim=1024,
    num_layers=24, num_heads=16, ff_dim=4096, layer_norm_first=True)
HUBERT_XLARGE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_bias=True, embed_dim=1280,
    num_layers=48, num_heads=16, ff_dim=5120, layer_norm_first=True)

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
                self.add_module(f"norm{i}", nn.LayerNorm(feats, eps=1e-5))
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
    is dropped.  Weight (E, E/groups, K) as torch's."""

    def __init__(self, embed_dim: int, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight = nn.Parameter(torch.empty(embed_dim, embed_dim // groups,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        nn.init.normal_(self.weight, std=(4.0 / (kernel * embed_dim)) ** 0.5)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype),
                     padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[:, :, :-1]
        return gelu(y.transpose(1, 2), "erf")


class Wav2Vec2Model(nn.Module):
    """Conv encoder + feature projection + transformer: (B, L) -> the last
    transformer layer's output (B, T, E), the tensor the reference's
    wav2vec-2 extractor gave (`extract_features(x)[0][-1]`).

    `num_outputs` runs only the first that many layers, as torchaudio's
    num_layers; the pre-LN models' final `encoder_norm` applies on the full
    forward only (HF's last_hidden_state), never after a truncated stack."""

    def __init__(self, config: Wav2Vec2Config = WAV2VEC2_BASE):
        super().__init__()
        cfg = self.config = config
        e = cfg.embed_dim
        self.feature_extractor = ConvFeatureEncoder(
            cfg.conv_layers, cfg.extractor_mode, cfg.conv_bias)
        width = cfg.conv_layers[-1][0]
        self.fp_norm = nn.LayerNorm(width, eps=1e-5)
        self.fp_proj = Linear(width, e)
        self.dropout = Dropout(cfg.dropout)
        self.pos_conv = ConvPositionalEmbedding(e, cfg.pos_conv_kernel,
                                                cfg.pos_conv_groups)
        self.encoder_norm = nn.LayerNorm(e, eps=1e-5)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(e, cfg.num_heads, cfg.ff_dim, cfg.dropout,
                                    activation="gelu",
                                    norm_first=cfg.layer_norm_first)
            for _ in range(cfg.num_layers))

    def forward(self, x, num_outputs: Optional[int] = None):
        cfg = self.config
        h = self.dropout(self.fp_proj(self.fp_norm(self.feature_extractor(x))))
        h = h + self.pos_conv(h)
        if not cfg.layer_norm_first:
            h = self.encoder_norm(h)
        h = self.dropout(h)
        n_layers = cfg.num_layers if num_outputs is None else num_outputs
        for layer in self.layers[:n_layers]:
            h = layer(h)
        if cfg.layer_norm_first and num_outputs is None:
            h = self.encoder_norm(h)
        return h


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
