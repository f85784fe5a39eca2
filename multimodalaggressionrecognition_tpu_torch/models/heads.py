"""Sequence-classification heads (the JAX package's models/heads.py).

- `FeatureSequenceProcessing`: a GRU, an LSTM or the mean over time on a
  (B, T, E) feature sequence, its last timestep, then Linear(., 256) ->
  ReLU -> Dropout(0.5) -> Linear(256, classes) (the reference's sequence
  heads).  flax infers each layer's input width; torch needs it, so the
  feature width E is an argument: it feeds the RNN and, for 'avg', fc1;
- `MultiHeadModel`: several heads over one feature tensor, optionally after
  a frozen extractor (every entry freezes its extractor, so the JAX
  module's `freeze_extractor` flag is not carried over) -> {head: logits};
- `TransformerSequenceClassifier`: the reference's
  `TransformerSequenceProcessor` with its intended classifier live, a
  transformer encoder over a (B, T, E) feature sequence without positional
  encoding, mean-pooled, then Linear(E, 256) -> ReLU -> Dropout(0.3) ->
  Linear(256, classes).  The JAX module's optional `extractor` is not
  ported: the entries that need one wrap it outside.

Not ported, as no entry uses them: `OutputClassifier`,
`VideoAverageFeatures`, `EmbeddingLayer` and `AudioTextAdaptor`.
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
                 num_heads: int = 8, dropout: float = 0.3):
        super().__init__()
        self.encoder = TransformerEncoder(hidden_size, num_heads, num_layers)
        self.fc1 = Linear(hidden_size, 256)
        self.fc2 = Linear(256, class_num)
        self.dropout = Dropout(dropout)

    def forward(self, x, return_type: str = "classifier",
                key_padding_mask=None):
        """x (B, T, E) -> logits (B, classes); `return_type` 'features'
        gives the encoder's (B, T, E) instead, 'all' both (logits,
        features)."""
        feats = self.encoder(x, key_padding_mask)
        if return_type == "features":
            return feats
        h = self.dropout(torch.relu(self.fc1(feats.mean(dim=1))))
        logits = self.fc2(h)
        if return_type == "all":
            return logits, feats
        return logits
