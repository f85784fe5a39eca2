"""Transformer layers with the JAX package's semantics (models/layers.py).

torch's default post-LN `nn.TransformerEncoderLayer` (ReLU, d_ff=2048)
inside `nn.TransformerEncoder(..., norm=LayerNorm)`, written out in full so
two documented divergences from torch hold:

- safe softmax: a query whose keys are ALL masked gets zero attention
  weights, not NaN.  Serving reaches this: `serve.Predictor` pads a batch
  with all-zero rows, every token of which is masked;
- in eval mode the masked rows are zeroed after the final norm (torch's
  nested-tensor fast path does the same).

The JAX package's `TorchLinear` is `nn.Linear` here and its
`TorchLayerNorm` is `nn.LayerNorm` (eps 1e-5).  The key-padding mask is
True for a masked key.  Parameter names follow torch's, so io/from_jax.py
maps the JAX trees onto them.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .stochastic import Dropout

class MultiheadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention (self-attention, batch_first) equivalent."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x, key_padding_mask=None):
        b, t, e = x.shape
        h = self.num_heads
        d = e // h
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        # (B, T, 3E) -> 3 x (B, H, T, d)
        q, k, v = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        if key_padding_mask is not None:
            any_valid = (~key_padding_mask).any(dim=-1)[:, None, None, None]
            attn = torch.where(any_valid, attn, torch.zeros_like(attn))
        out = self.dropout(attn) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, e))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with ReLU: torch's nn.TransformerEncoderLayer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        x = self.norm1(x + self.dropout(self.self_attn(x, key_padding_mask)))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(ff))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers + final LayerNorm; masked rows zeroed in eval."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        x = self.norm(x)
        if not self.training and key_padding_mask is not None:
            x = x.masked_fill(key_padding_mask[:, :, None], 0.0)
        return x


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from one `torch.Generator`, with the JAX
    package's initializers: fan-in uniform for Linear/Conv weights and
    biases (torch's defaults), Xavier-uniform packed qkv with zero biases,
    ones/zeros for norms, identity BatchNorm statistics, and Swin's
    relative-position bias tables from a normal with std 0.02 truncated at
    two standard deviations.  Deterministic on
    the CPU, so a model built this way and moved to any device carries the
    same weights."""
    from .nn1d import BatchNorm1d, Conv1d
    from .nn3d import Conv3d
    from .swin3d import ShiftedWindowAttention3d

    g = torch.Generator().manual_seed(seed)

    def fan_in_uniform_(t, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv1d, Conv3d)):
            fan_in = m.weight[0].numel()
            fan_in_uniform_(m.weight, fan_in)
            if m.bias is not None:
                fan_in_uniform_(m.bias, fan_in)
        elif isinstance(m, MultiheadSelfAttention):
            e3, e = m.in_proj_weight.shape
            bound = math.sqrt(6.0 / (e + e3))
            m.in_proj_weight.copy_(
                torch.rand(m.in_proj_weight.shape, generator=g) * (2 * bound)
                - bound)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ShiftedWindowAttention3d):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=g)
    for m in model.modules():  # after the Linear pass: MHA's out_proj bias
        if isinstance(m, MultiheadSelfAttention):
            m.out_proj.bias.zero_()
        elif isinstance(m, BatchNorm1d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model
