"""Late fusion over per-modality token sequences (the JAX package's
models/fusion.py).

- `EqualSizedTransformerModalitiesFusion`: concatenate the modalities'
  (B, T_m, H) tokens in sorted name order, mask every all-zero token row
  (absent-modality stubs and zero-padded tails), run one transformer
  encoder, split back by bounds;
- `AveragedFeaturesTransformerFusion`: the same after each modality is
  mean-pooled to one token (zero padding rows counted in the mean);
- `CrossAttentionFusion`: each modality's tokens attend, through one shared
  `MultiheadCrossAttention`, to the concatenation with its own tokens and
  every all-zero row masked; a query row with no valid key gets zero
  attention; then a shared LayerNorm of the residual sum.  Its scores,
  softmax and attention-weighted values are f32 whatever the compute
  dtype, as the JAX module accumulates them (`preferred_element_type`),
  so under bf16 `out_proj`, the residual and the norm run in f32.
"""

import math
from typing import Dict

import torch
from torch import nn

from .layers import LayerNorm, Linear, TransformerEncoder
from .stochastic import Dropout


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


class AveragedFeaturesTransformerFusion(EqualSizedTransformerModalitiesFusion):
    def forward(self, feats: Dict[str, torch.Tensor]):
        return super().forward({k: v.mean(dim=1, keepdim=True)
                                for k, v in feats.items()})


class MultiheadCrossAttention(nn.Module):
    """Queries from x (B, T, E), keys and values from memory (B, S, E);
    `key_padding_mask` (B, S) is True for a masked key."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def forward(self, x, memory, key_padding_mask=None):
        b, t, e = x.shape
        s, h = memory.shape[1], self.num_heads
        d = e // h

        def heads(z, length):
            return z.view(b, length, h, d).transpose(1, 2).float()

        q = heads(self.q_proj(x), t)
        k = heads(self.k_proj(memory), s)
        v = heads(self.v_proj(memory), s)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1)
        if key_padding_mask is not None:
            any_valid = (~key_padding_mask).any(dim=-1)[:, None, None, None]
            attn = torch.where(any_valid, attn, torch.zeros_like(attn))
        out = self.dropout(attn) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, e))


class CrossAttentionFusion(nn.Module):
    def __init__(self, hidden_size: int = 768, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.cross_attn = MultiheadCrossAttention(hidden_size, num_heads,
                                                  dropout)
        self.norm = LayerNorm(hidden_size, eps=1e-5)

    def forward(self, feats: Dict[str, torch.Tensor]):
        concat, bounds = concat_with_bounds(feats)
        mask = zero_row_mask(concat)
        out = {}
        for name in sorted(feats):
            b0, b1 = bounds[name]
            own = torch.zeros_like(mask)
            own[:, b0:b1] = True  # each modality attends only to the others
            fused = self.cross_attn(feats[name], concat,
                                    key_padding_mask=mask | own)
            out[name] = self.norm(feats[name] + fused)
        return out
