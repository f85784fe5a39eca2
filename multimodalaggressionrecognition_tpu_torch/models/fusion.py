"""Late fusion over per-modality token sequences (the JAX package's
models/fusion.py): concatenate the modalities' (B, T_m, H) tokens in sorted
name order, mask every all-zero token row (absent-modality stubs and
zero-padded tails), run one transformer encoder, split back by bounds.
The Averaged and CrossAttention fusions are not ported yet.
"""

from typing import Dict

import torch
from torch import nn

from .layers import TransformerEncoder


def concat_with_bounds(feats: Dict[str, torch.Tensor]):
    """Concatenate sorted-by-name (B, T_m, H) features; return bounds per name."""
    bounds = {}
    offset = 0
    for name in sorted(feats):
        t = feats[name].shape[1]
        bounds[name] = (offset, offset + t)
        offset += t
    return torch.cat([feats[n] for n in sorted(feats)], dim=1), bounds


def zero_row_mask(tokens):
    """True where a token's features sum to exactly zero (reference semantics)."""
    return tokens.sum(dim=2) == 0


class EqualSizedTransformerModalitiesFusion(nn.Module):
    def __init__(self, num_layers: int = 1, hidden_size: int = 768,
                 num_heads: int = 8):
        super().__init__()
        self.encoder = TransformerEncoder(hidden_size, num_heads, num_layers)

    def forward(self, feats: Dict[str, torch.Tensor]):
        concat, bounds = concat_with_bounds(feats)
        fused = self.encoder(concat, key_padding_mask=zero_row_mask(concat))
        return {name: fused[:, b0:b1] for name, (b0, b1) in bounds.items()}
