"""Sequence-classification heads (the JAX package's models/heads.py).

Only `TransformerSequenceClassifier` is ported: the reference's
`TransformerSequenceProcessor` with its intended classifier live, a
transformer encoder over a (B, T, E) feature sequence without positional
encoding, mean-pooled, then Linear(E, 256) -> ReLU -> Dropout(0.3) ->
Linear(256, classes).  The JAX module's optional `extractor` is not
ported: the text entry feeds RuBERT token embeddings directly.
"""

import torch
from torch import nn

from .layers import TransformerEncoder
from .stochastic import Dropout


class TransformerSequenceClassifier(nn.Module):
    def __init__(self, class_num: int, hidden_size: int, num_layers: int = 2,
                 num_heads: int = 8, dropout: float = 0.3):
        super().__init__()
        self.encoder = TransformerEncoder(hidden_size, num_heads, num_layers)
        self.fc1 = nn.Linear(hidden_size, 256)
        self.fc2 = nn.Linear(256, class_num)
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
