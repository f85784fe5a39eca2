"""Sequence-classification heads (the JAX package's models/heads.py).

flax infers each layer's input width; torch needs it, so the modules that
start with a Linear take their input width as an argument.

- `FeatureSequenceProcessing`: a GRU, an LSTM or the mean over time on a
  (B, T, E) feature sequence, its last timestep, then Linear(., 256) ->
  ReLU -> Dropout(0.5) -> Linear(256, classes) (the reference's sequence
  heads).  The feature width E feeds the RNN and, for 'avg', fc1;
- `EmbeddingLayer`: a per-timestep Linear + ReLU;
- `VideoAverageFeatures`: the mean over time, then Linear(E, 256) -> ReLU
  -> Dropout(0.5) -> Linear(256, classes);
- `AudioTextAdaptor`: per modality Linear + ReLU + Dropout(0.3) and the
  mean over time, the modalities combined by concat, sum or mean;
- `OutputClassifier`: the mean over time of a (B, T, E) input (a (B, E)
  input as it is), then Linear(E, 256) -> ReLU -> Dropout(0.3) ->
  Linear(256, classes);
- `MultiHeadModel`: several heads over one feature tensor, optionally after
  a frozen extractor (every entry freezes its extractor, so the JAX
  module's `freeze_extractor` flag is not carried over) -> {head: logits};
- `TransformerSequenceClassifier`: the reference's
  `TransformerSequenceProcessor` with its intended classifier live, a
  transformer encoder over a (B, T, E) feature sequence without positional
  encoding, mean-pooled, then Linear(E, 256) -> ReLU -> Dropout(0.3) ->
  Linear(256, classes); an optional `extractor` runs first.

An extractor runs in eval mode whatever the model's mode, as the JAX
modules call it without `train`; a frozen one also without gradient (the
JAX modules' `stop_gradient`).
"""

from typing import Mapping, Optional

import torch
from torch import nn

from .layers import Linear, TransformerEncoder
from .rnn import GRU, LSTM
from .stochastic import Dropout


class AverageFeatureSequence(nn.Module):
    """Mean over time, shaped like an RNN's output: ((B, 1, E), None)."""

    def forward(self, x):
        return x.mean(dim=1, keepdim=True), None


class FeatureSequenceProcessing(nn.Module):
    """RNN-or-average head classifying the last timestep: (B, T, E) ->
    logits (B, class_num).  `hidden_size` is the RNN's width (unused by
    'avg', whose fc1 takes the feature width)."""

    def __init__(self, class_num: int, hidden_size: int, cell: str = "gru",
                 *, input_size: int, dropout: float = 0.5):
        super().__init__()
        if cell == "gru":
            self.sequence_nn = GRU(input_size, hidden_size)
        elif cell == "lstm":
            self.sequence_nn = LSTM(input_size, hidden_size)
        elif cell == "avg":
            self.sequence_nn = AverageFeatureSequence()
        else:
            raise ValueError(f"unknown cell {cell!r}")
        self.fc1 = Linear(input_size if cell == "avg" else hidden_size, 256)
        self.fc2 = Linear(256, class_num)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        seq, _ = self.sequence_nn(x)
        return self.fc2(self.dropout(torch.relu(self.fc1(seq[:, -1, :]))))


class EmbeddingLayer(nn.Module):
    """(B, T, input_size) -> (B, T, output_size): Linear + ReLU."""

    def __init__(self, output_size: int, *, input_size: int):
        super().__init__()
        self.fc = Linear(input_size, output_size)

    def forward(self, x):
        return torch.relu(self.fc(x))


class _MeanClassifier(nn.Module):
    """Linear(input_size, 256) -> ReLU -> Dropout -> Linear(256, classes)
    on the mean over time of a (B, T, E) input."""

    def __init__(self, class_num: int, *, input_size: int, dropout: float):
        super().__init__()
        self.fc1 = Linear(input_size, 256)
        self.fc2 = Linear(256, class_num)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.fc2(self.dropout(torch.relu(self.fc1(x.mean(dim=1)))))


class VideoAverageFeatures(_MeanClassifier):
    def __init__(self, class_num: int, *, input_size: int,
                 dropout: float = 0.5):
        super().__init__(class_num, input_size=input_size, dropout=dropout)


class OutputClassifier(_MeanClassifier):
    def __init__(self, class_num: int, *, input_size: int,
                 dropout: float = 0.3):
        super().__init__(class_num, input_size=input_size, dropout=dropout)

    def forward(self, x):
        return super().forward(x if x.ndim == 3 else x[:, None])


class AudioTextAdaptor(nn.Module):
    """{modality: (B, T_m, E_m)} -> (B, target_dim * present) for
    'concat', (B, target_dim) for 'sum' and otherwise the mean; modalities
    absent from the input are skipped.  `input_sizes` gives each
    modality's E_m."""

    def __init__(self, target_dim: int, *, input_sizes: Mapping[str, int],
                 modalities=("audio", "text"), dropout: float = 0.3,
                 combination: str = "concat"):
        super().__init__()
        self.modalities = tuple(modalities)
        self.combination = combination
        self.dropout = Dropout(dropout)
        for name in self.modalities:
            self.add_module(f"adaptor_{name}",
                            Linear(input_sizes[name], target_dim))

    def forward(self, features):
        outs = [self.dropout(torch.relu(getattr(self, f"adaptor_{name}")(
            features[name]))).mean(dim=1)
            for name in self.modalities if name in features]
        if self.combination == "concat":
            return torch.cat(outs, dim=1)
        stacked = torch.stack(outs, dim=1)
        return (stacked.sum(dim=1) if self.combination == "sum"
                else stacked.mean(dim=1))


class MultiHeadModel(nn.Module):
    """Several independent heads over one feature tensor -> {name: logits}.

    The `extractor`, when given, is frozen: it has no trainable parameters,
    runs without gradient and stays in eval mode when the model trains, as
    the JAX module calls it without `train` and under `stop_gradient`: a
    CNN1D extractor keeps its running BatchNorm statistics, and its stem
    takes the framed-conv kernel with the folded BatchNorm and ReLU."""

    def __init__(self, heads: Mapping[str, nn.Module],
                 extractor: Optional[nn.Module] = None):
        super().__init__()
        self.heads = nn.ModuleDict(heads)
        self.extractor = extractor
        if extractor is not None:
            extractor.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.extractor is not None:
            self.extractor.eval()
        return self

    def forward(self, x):
        if self.extractor is not None:
            with torch.no_grad():
                x = self.extractor(x)
        return {name: head(x) for name, head in self.heads.items()}


class TransformerSequenceClassifier(nn.Module):
    def __init__(self, class_num: int, hidden_size: int, num_layers: int = 2,
                 num_heads: int = 8, dropout: float = 0.3,
                 extractor: Optional[nn.Module] = None,
                 freeze_extractor: bool = False):
        super().__init__()
        self.extractor = extractor
        self.freeze_extractor = freeze_extractor
        if extractor is not None and freeze_extractor:
            extractor.requires_grad_(False)
        self.encoder = TransformerEncoder(hidden_size, num_heads, num_layers)
        self.fc1 = Linear(hidden_size, 256)
        self.fc2 = Linear(256, class_num)
        self.dropout = Dropout(dropout)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.extractor is not None:
            self.extractor.eval()
        return self

    def forward(self, x, return_type: str = "classifier",
                key_padding_mask=None):
        """x (B, T, E) (the extractor's input when there is one) ->
        logits (B, classes); `return_type` 'features' gives the encoder's
        (B, T, E) instead, 'all' both (logits, features)."""
        if self.extractor is not None:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.freeze_extractor):
                x = self.extractor(x)
        feats = self.encoder(x, key_padding_mask)
        if return_type == "features":
            return feats
        h = self.dropout(torch.relu(self.fc1(feats.mean(dim=1))))
        logits = self.fc2(h)
        if return_type == "all":
            return logits, feats
        return logits
