"""Transformer layers with the JAX package's semantics (models/layers.py).

torch's default post-LN `nn.TransformerEncoderLayer` (ReLU, d_ff=2048)
inside `nn.TransformerEncoder(..., norm=LayerNorm)`, written out in full so
two documented divergences from torch hold:

- safe softmax: a query whose keys are ALL masked gets zero attention
  weights, not NaN.  Serving reaches this: `serve.Predictor` pads a batch
  with all-zero rows, every token of which is masked;
- in eval mode the masked rows are zeroed after the final norm (torch's
  nested-tensor fast path does the same).

The JAX package's `TorchLinear` is `Linear` here (nn.Linear, with the
int8 path of w8a8 serving) and its `TorchLayerNorm` is `LayerNorm`
(nn.LayerNorm, eps 1e-5, in f32 under a lower compute dtype).  As in the
JAX package, a layer computes in its input's dtype with its weights cast
to it: under bf16 compute (utils/precision.py) a bf16 input runs in bf16,
and an f32 one (the output of an op that returns f32, such as a GRU's)
runs in f32 on the bf16-rounded weights.  The key-padding mask is True
for a masked key.  Parameter names follow torch's, so io/from_jax.py maps
the JAX trees onto them.

Tensor parallelism (parallel/sharding_rules.py sets `tp` = (group, rank,
size)): the attention runs this rank's heads, the feed-forward block its
columns of `linear1`; `out_proj` and `linear2` multiply by their column
shards, one all-reduce over the group sums the partial products, and
their bias is added once, after it.  The block's input goes through the
identity forward / all-reduce backward (Megatron's f and g).  The w8a8
branch runs unsharded (serving).

Tensor-parallel serving in one process (`place_params_local` sets
`tp_shards`, one module of split parameters per device): each shard in
rank order takes the input to its device and runs the same per-rank math
there, every shard is enqueued before any partial is read back, and the
partials are summed on the input's device in rank order
(`parallel/mesh.sum_partials`) before the bias is added.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.self_attention import kernel_takes, self_attention
from ..ops.erf import gelu
from ..parallel.mesh import copy_to_group, reduce_from_group, sum_partials
from .stochastic import Dropout


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that normalizes in f32 and returns its input's dtype:
    under bf16 compute the statistics, the affine and the gradients of
    the weight and bias are f32 sums, as in the JAX package's
    TorchLayerNorm (torch's CPU kernel sums a bf16 input's weight and bias
    gradients in bf16).  The identity of nn.LayerNorm in f32."""

    def forward(self, x):
        if x.dtype == self.weight.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear in its input's dtype (a float weight and bias cast to it),
    quant-aware as the JAX TorchLinear is: holding an int8 weight and its
    `weight_scale` (w8a8 serving, utils/quantize.py) it runs int8 x int8 ->
    int32 on dynamically quantized activations."""

    def forward(self, x):
        if self.weight.dtype != torch.int8:
            return F.linear(x, self.weight.to(x.dtype),
                            None if self.bias is None
                            else self.bias.to(x.dtype))
        from ..utils.quantize import int8_linear

        return int8_linear(x, self.weight, self.weight_scale, self.bias)


class MultiheadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention (self-attention, batch_first) equivalent."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)
        self.tp = None  # (group, rank, size) on a tensor-parallel mesh
        self.tp_shards = None  # one process's split over several devices
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def _attend(self, qkv, key_padding_mask, rank: int, size: int):
        """The attention of the heads whose packed q, k, v rows `qkv` (B, T,
        3 h d) holds (rank's h = num_heads / size): (B, T, h d).  Without
        a key padding mask, a CUDA bf16 qkv at a head dim the kernels take
        runs ops/cuda/self_attention.py's kernels on the dropout's own
        draw; anything else the composition below."""
        b, t, _ = qkv.shape
        h = self.num_heads // size
        d = qkv.shape[-1] // (3 * h)
        if key_padding_mask is None and kernel_takes(qkv, d):
            drop = self.dropout
            u = (drop.draw((b, h, t, t), qkv.device, shards=((1, rank, size),))
                 if drop.training and drop.rate != 0.0 else None)
            return self_attention(qkv, u, h, 1.0 - drop.rate)
        # (B, T, 3E) -> 3 x (B, H, T, d)
        q, k, v = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        # the scores and the softmax in f32 whatever the compute dtype, the
        # weights back in it for P.V (the JAX layer's f32 accumulation)
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        if key_padding_mask is not None:
            any_valid = (~key_padding_mask).any(dim=-1)[:, None, None, None]
            attn = torch.where(any_valid, attn, torch.zeros_like(attn))
        out = self.dropout(attn.to(v.dtype), shards=((1, rank, size),)) @ v
        return out.transpose(1, 2).reshape(b, t, h * d)

    def forward(self, x, key_padding_mask=None):
        if self.tp_shards is not None:
            return self._forward_local(x, key_padding_mask)
        group, rank, size = self.tp or (None, 0, 1)
        if group is not None:
            x = copy_to_group(x, group)
        if self.in_proj_weight.dtype == torch.int8:  # w8a8 serving
            from ..utils.quantize import int8_linear

            qkv = int8_linear(x, self.in_proj_weight,
                              self.in_proj_weight_scale, self.in_proj_bias)
        else:
            qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                           self.in_proj_bias.to(x.dtype))
        out = self._attend(qkv, key_padding_mask, rank, size)
        if group is None:
            return self.out_proj(out)
        partial = F.linear(out, self.out_proj.weight.to(out.dtype))
        return (reduce_from_group(partial, group)
                + self.out_proj.bias.to(out.dtype))

    def _forward_local(self, x, key_padding_mask):
        size = len(self.tp_shards)
        partials = []
        for rank, shard in enumerate(self.tp_shards):
            w = shard.in_proj_weight
            xs = x.to(w.device)
            mask = (None if key_padding_mask is None
                    else key_padding_mask.to(w.device))
            qkv = F.linear(xs, w.to(xs.dtype), shard.in_proj_bias.to(xs.dtype))
            out = self._attend(qkv, mask, rank, size)
            partials.append(F.linear(out, shard.out_proj_weight.to(out.dtype)))
        return (sum_partials(partials, x.device)
                + self.out_proj.bias.to(x.dtype))


class TransformerEncoderLayer(nn.Module):
    """torch's nn.TransformerEncoderLayer: post-LN with ReLU by default;
    `activation` 'gelu' (the exact GELU) and `norm_first` (pre-LN) are the
    wav2vec-2 and HuBERT variants.  `dropout` is every dropout's rate
    unless `attention_dropout` (the attention weights') or
    `activation_dropout` (the feed-forward's hidden units') is given (HF
    wav2vec-2's separate rates); a rate of 0 draws nothing."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 norm_first: bool = False,
                 attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"activation must be 'relu' or 'gelu', got "
                             f"{activation!r}")
        self.activation, self.norm_first = activation, norm_first
        self.self_attn = MultiheadSelfAttention(
            d_model, nhead,
            dropout if attention_dropout is None else attention_dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.activation_dropout = Dropout(
            dropout if activation_dropout is None else activation_dropout)
        self.tp = None  # (group, rank, size): linear1/linear2 split
        self.tp_shards = None  # one process's split over several devices

    def _hidden(self, h, rank: int, size: int):
        """The activation and dropout of rank's columns of linear1's
        output."""
        h = gelu(h, "erf") if self.activation == "gelu" else torch.relu(h)
        return self.activation_dropout(h, shards=((-1, rank, size),))

    def _ff(self, x):
        if self.tp_shards is not None:
            return self.dropout(self._ff_local(x))
        group, rank, size = self.tp or (None, 0, 1)
        if group is not None:
            x = copy_to_group(x, group)
        h = self._hidden(self.linear1(x), rank, size)
        if group is None:
            return self.dropout(self.linear2(h))
        partial = F.linear(h, self.linear2.weight.to(h.dtype))
        return self.dropout(reduce_from_group(partial, group)
                            + self.linear2.bias.to(h.dtype))

    def _ff_local(self, x):
        size = len(self.tp_shards)
        partials = []
        for rank, shard in enumerate(self.tp_shards):
            w1 = shard.linear1_weight
            xs = x.to(w1.device)
            h = self._hidden(F.linear(xs, w1.to(xs.dtype),
                                      shard.linear1_bias.to(xs.dtype)),
                             rank, size)
            partials.append(F.linear(h, shard.linear2_weight.to(h.dtype)))
        return sum_partials(partials, x.device) + self.linear2.bias.to(x.dtype)

    def forward(self, x, key_padding_mask=None):
        if self.norm_first:
            x = x + self.dropout(self.self_attn(self.norm1(x),
                                                key_padding_mask))
            return x + self._ff(self.norm2(x))
        x = self.norm1(x + self.dropout(self.self_attn(x, key_padding_mask)))
        return self.norm2(x + self._ff(x))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers + final LayerNorm; masked rows zeroed in eval."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-5)

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
    two standard deviations; GRU and LSTM weights and biases from
    U(+-1/sqrt(H)); wav2vec's positional conv from a normal with std
    sqrt(4 / (K * E)) and a zero bias (weight-normed: v so, g its norm)
    and its time mask's embedding from U[0, 1); GigaChat's RMSNorms at
    one, its router and stacked experts fan-in uniform with a zero
    correction bias, its token embedding from a normal with std 0.02 (HF's
    `initializer_range`).  Deterministic on
    the CPU, so a model built this way and moved to any device carries the
    same weights."""
    from .gigachat import HeldExperts, MoEGate, RMSNorm
    from .nn1d import BatchNorm1d, Conv1d
    from .nn3d import Conv2d, Conv3d
    from .swin3d import PatchEmbed3d, ShiftedWindowAttention3d
    from .wav2vec import (ConvPositionalEmbedding, Wav2Vec2Model,
                          weight_norm_of)

    g = torch.Generator().manual_seed(seed)

    def fan_in_uniform_(t, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv1d, Conv2d, Conv3d, PatchEmbed3d)):
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
        elif isinstance(m, nn.RNNBase):
            for p in m.parameters(recurse=False):
                fan_in_uniform_(p, m.hidden_size)
        elif isinstance(m, ConvPositionalEmbedding):
            w = m.weight_v if m.weight_norm else m.weight
            k, e = w.shape[-1], w.shape[0]
            w.copy_(torch.randn(w.shape, generator=g)
                    * math.sqrt(4.0 / (k * e)))
            if m.weight_norm:
                m.weight_g.copy_(weight_norm_of(w))
            m.bias.zero_()
        elif isinstance(m, Wav2Vec2Model) and hasattr(m, "masked_spec_embed"):
            m.masked_spec_embed.copy_(
                torch.rand(m.masked_spec_embed.shape, generator=g))
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, MoEGate):
            fan_in_uniform_(m.weight, m.weight.shape[1])
            m.e_score_correction_bias.zero_()
        elif isinstance(m, HeldExperts):
            fan_in_uniform_(m.gate_up_proj, m.gate_up_proj.shape[2])
            fan_in_uniform_(m.down_proj, m.down_proj.shape[2])
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.02)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, BatchNorm1d)):
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
