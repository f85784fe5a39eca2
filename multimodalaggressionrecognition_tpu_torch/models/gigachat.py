"""GigaChat3.1's decoder (`deepseek_v3`) as the text tower of the multimodal
model: token ids in, one feature vector a token out.

The sizes come from a `GigaChatConfig` in HuggingFace's names
(`ai-sage/GigaChat3.1-702B-A36B`'s `config.json`).  A layer is

  h = x + MLA(RMSNorm(x));  out = h + FFN(RMSNorm(h))

with FFN a SwiGLU (`intermediate_size` wide) in the first
`first_k_dense_replace` layers and a mixture of experts after them; the
stack ends in an RMSNorm, and `GigaChatTextExtractor` maps it to the
fusion's width (Linear, ReLU) and zeroes the pad positions, so the fusion
masks them as it masks any all-zero token.  No LM head and no MTP module:
the tower is fine-tuned for classification, its token embedding frozen.

- RMSNorm computes in float32 (`x * rsqrt(mean(x^2) + eps) * w`) and
  returns its input's dtype; its backward recomputes from the input and the
  saved reciprocal, so a norm keeps no float32 copy for the backward.
- Latent attention (MLA): q from a low-rank path (`q_a_proj`, RMSNorm,
  `q_b_proj`), k and v from a shared latent (`kv_a_proj_with_mqa` gives
  the latent and one 64-wide RoPE key for all heads, RMSNorm, `kv_b_proj`);
  the RoPE halves are de-interleaved and rotated by `rotate_half`, as in the
  `deepseek_v3` modeling code, with YaRN frequencies; causal softmax
  attention at scale `qk_head_dim^-1/2 * mscale^2`.  A CUDA bf16 step runs
  it through `F.scaled_dot_product_attention(is_causal=True)` (flash),
  anything else through the composition.  The batch is right-padded, so a
  valid query never sees a pad key and no padding mask is needed.
- Mixture of experts: sigmoid scores over every routed expert, plus the
  correction bias (a buffer: it takes no gradient) to choose; group-limited
  top-k (`noaux_tc`): the top `topk_group` of `n_group` groups by the sum of
  each group's two best choice scores, the other groups' scores set to 0,
  then the top `num_experts_per_tok`; the chosen experts' sigmoid scores
  normalized and scaled by `routed_scaling_factor`.  An expert-parallel
  share (`expert_parallel` > 1) holds the `n_routed_experts` experts from
  `expert_rank * n_routed_experts` on of the layer's `n_routed_experts *
  expert_parallel`, routes over all of them and adds only its own
  experts' part: what the other
  shares' experts would add is left out, and the partial sum goes on to the
  next layer.  The shared expert runs on every token.  Pad positions are
  never routed.
- The held experts' products: on a CUDA bf16 step, grouped products over
  device-side row offsets (`torch._grouped_mm`), every assignment kept (no
  capacity, no dropped token) and no host readback; their inside is
  recomputed in the backward, so a layer keeps only its input.  Elsewhere
  (the CPU, float32) a loop over the held experts; both take the same
  sorted rows and sum a token's experts in the same order.  `MoE.rows`
  (`GigaChatModel.expert_rows()`) counts each held expert's rows on the
  device, outside any recording.
"""

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import backward_mark, span
from .layers import Linear


@dataclass(frozen=True)
class GigaChatConfig:
    """The decoder's sizes in HuggingFace's `deepseek_v3` names, on one
    share of an expert-parallel deployment: `expert_parallel` shares
    divide each layer's routed experts, and this one, the
    `expert_rank`-th, holds `n_routed_experts` of them (the router stays
    `n_routed_experts * expert_parallel` wide)."""
    vocab_size: int = 128256
    hidden_size: int = 7168
    intermediate_size: int = 18432
    moe_intermediate_size: int = 2048
    num_hidden_layers: int = 64
    first_k_dense_replace: int = 3
    num_attention_heads: int = 64
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 192
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    n_group: int = 8
    topk_group: int = 4
    routed_scaling_factor: float = 2.5
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    rope_theta: float = 100000.0
    rope_scaling: dict = field(default_factory=lambda: {
        "rope_type": "yarn", "factor": 64,
        "original_max_position_embeddings": 4096, "beta_fast": 32,
        "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1})
    expert_parallel: int = 1
    expert_rank: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> int:
        return self.n_routed_experts

    @property
    def router_experts(self) -> int:
        return self.n_routed_experts * self.expert_parallel

    @property
    def first_expert(self) -> int:
        return self.expert_rank * self.n_routed_experts

    @classmethod
    def from_hf(cls, cfg: dict, **overrides):
        """The config of a `config.json`-like dict (unknown keys ignored)."""
        names = {f for f in cls.__dataclass_fields__}
        kw = {k: v for k, v in cfg.items() if k in names}
        kw.update(overrides)
        return cls(**kw)


GIGACHAT3_1 = GigaChatConfig()  # as published
# one chip's share of the text tower's fine-tune (the benchmark's cell): the
# routed experts over 32 chips (this one holds experts 0-7), one pipeline
# stage of 1 dense and 4 MoE layers, the whole vocabulary
GIGACHAT3_1_EP32 = replace(GIGACHAT3_1, num_hidden_layers=5,
                           first_k_dense_replace=1, n_routed_experts=8,
                           expert_parallel=32)


# ---------------------------------------------------------------- RoPE
def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: GigaChatConfig):
    """The YaRN inverse frequencies of the RoPE pairs, float64 numbers:
    `f_inter * (1 - m) + f_extra * m` with `f_extra = theta^(-2i/d)`,
    `f_inter = f_extra / factor` and `m` one minus the linear ramp between
    the correction dims of `beta_fast` and `beta_slow`."""
    s, d, base = cfg.rope_scaling, cfg.qk_rope_head_dim, cfg.rope_theta
    original = s["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (d * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(s["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(s["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    out = []
    for i in range(d // 2):
        extra = 1.0 / base ** (2 * i / d)
        inter = extra / s["factor"]
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        m = 1.0 - ramp
        out.append(inter * (1 - m) + extra * m)
    return out


def softmax_scale(cfg: GigaChatConfig) -> float:
    s = cfg.rope_scaling
    m = yarn_get_mscale(s["factor"], s["mscale_all_dim"])
    return cfg.qk_head_dim ** -0.5 * m * m


def rope_tables(cfg: GigaChatConfig, length: int, device):
    """(cos, sin), each (length, rope dim) float32: cos and sin of
    `cat(f, f)` at each position, times `mscale / mscale_all_dim`."""
    s = cfg.rope_scaling
    scale = (yarn_get_mscale(s["factor"], s["mscale"])
             / yarn_get_mscale(s["factor"], s["mscale_all_dim"]))
    inv = torch.tensor(yarn_inv_freq(cfg), dtype=torch.float64)
    freqs = torch.outer(torch.arange(length, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return ((emb.cos() * scale).float().to(device),
            (emb.sin() * scale).float().to(device))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """x (..., T, heads, d): de-interleaved (pairs (2i, 2i+1) to (i, i +
    d/2)), then rotated; cos, sin (T, d) in x's dtype."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


# ---------------------------------------------------------------- layers
class _RMSNormFn(torch.autograd.Function):
    """RMSNorm in float32 that saves its input and the reciprocal RMS."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (xf * rstd * weight.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        n = x.float() * rstd
        gf = g.float()
        gw = (gf * n).reshape(-1, n.shape[-1]).sum(0)
        gn = gf * weight.float()
        gx = rstd * (gn - n * (gn * n).mean(-1, keepdim=True))
        return gx.to(x.dtype), gw.to(weight.dtype), None


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return _RMSNormFn.apply(x, self.weight, self.eps)


def causal_attention(q, k, v, scale: float):
    """Causal softmax attention of (B, heads, T, d) q, k, v: flash on a
    CUDA bf16 input, else the composition (float32 scores and softmax)."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    t = q.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    future = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


class MLA(nn.Module):
    """Multi-head latent attention (`DeepseekV3Attention`), no bias."""

    def __init__(self, cfg: GigaChatConfig):
        super().__init__()
        self.cfg = cfg
        e, heads = cfg.hidden_size, cfg.num_attention_heads
        self.q_a_proj = Linear(e, cfg.q_lora_rank, bias=False)
        self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps)
        self.q_b_proj = Linear(cfg.q_lora_rank, heads * cfg.qk_head_dim,
                               bias=False)
        self.kv_a_proj_with_mqa = Linear(
            e, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(
            cfg.kv_lora_rank,
            heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = Linear(heads * cfg.v_head_dim, e, bias=False)
        self.scale = softmax_scale(cfg)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        heads, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim)
        q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        q_nope, q_pe = q.view(b, t, heads, -1).split([nope, rope], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split(
            [cfg.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, t, heads, -1)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe[:, :, None], cos, sin)
        k = torch.cat([k_nope, k_pe.expand(b, t, heads, rope)], dim=-1)
        out = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, -1))


class SwiGLU(nn.Module):
    """`down(silu(gate(x)) * up(x))` (`DeepseekV3MLP`)."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = Linear(hidden, width, bias=False)
        self.up_proj = Linear(hidden, width, bias=False)
        self.down_proj = Linear(width, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


# ---------------------------------------------------------------- routing
class MoEGate(nn.Module):
    """The router: its weight (all experts' rows) and the correction bias,
    a buffer added to the scores only to choose."""

    def __init__(self, cfg: GigaChatConfig):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.router_experts,
                                               cfg.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.router_experts))

    def forward(self, x):
        """x (N, hidden) -> (expert ids (N, k), weights (N, k) float32)."""
        return route(x, self.weight, self.e_score_correction_bias, self.cfg)


def route(x, weight, bias, cfg: GigaChatConfig):
    """Group-limited top-k over sigmoid scores (`noaux_tc`)."""
    scores = F.linear(x.float(), weight.float()).sigmoid()
    n, experts = scores.shape
    with torch.no_grad():
        choice = scores + bias.float()
        groups = choice.view(n, cfg.n_group, -1).topk(
            2, dim=-1).values.sum(-1)
        kept = groups.topk(cfg.topk_group, dim=-1, sorted=False).indices
        mask = torch.zeros_like(groups).scatter_(1, kept, 1.0)
        mask = mask[:, :, None].expand(n, cfg.n_group, experts // cfg.n_group)
        choice = choice.masked_fill(mask.reshape(n, experts) == 0, 0.0)
        ids = choice.topk(cfg.num_experts_per_tok, dim=-1,
                          sorted=False).indices
    w = scores.gather(1, ids)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids, w * cfg.routed_scaling_factor


def held_keys(ids, valid, first: int, held: int):
    """(N * k,) the held expert (0 .. held - 1) of each assignment, token
    by token in slot order; `held` where the expert is not held here or
    the token is a pad."""
    local = ids - first
    here = (local >= 0) & (local < held) & valid[:, None]
    return torch.where(here, local, torch.full_like(local, held)).reshape(-1)


def _unsort_sum(y, order, keep, k: int):
    """Rows `y` (M, D) in sorted order -> each token's sum over its k
    assignments, in slot order: (M / k, D).  A row of no held expert
    (`keep` False; a grouped product leaves what it likes there) counts as
    0: it is copied to a spare row, which is dropped."""
    m = y.shape[0]
    out = y.new_zeros(m + 1, y.shape[-1])
    out.index_copy_(0, torch.where(keep, order, m), y)
    return out[:m].view(-1, k, y.shape[-1]).sum(1)


class _Gather(torch.autograd.Function):
    """x (N, D) -> its rows of the sorted assignments (M, D); the backward
    sums each token's rows of held experts in slot order (deterministic, no
    atomics)."""

    @staticmethod
    def forward(ctx, x, order, k, keep):
        ctx.save_for_backward(order, keep)
        ctx.k = k
        return x.index_select(0, torch.div(order, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, g):
        order, keep = ctx.saved_tensors
        return _unsort_sum(g, order, keep, ctx.k), None, None, None


class _Combine(torch.autograd.Function):
    """The adjoint of `_Gather`: sorted rows (M, D) -> each token's sum of
    its held experts' rows."""

    @staticmethod
    def forward(ctx, y, order, k, keep):
        ctx.save_for_backward(order)
        ctx.k = k
        return _unsort_sum(y, order, keep, k)

    @staticmethod
    def backward(ctx, g):
        order, = ctx.saved_tensors
        return g.index_select(0, torch.div(
            order, ctx.k, rounding_mode="floor")), None, None, None


def _grouped_rows(x, order, keep, w, offs, gate_up, down, k: int):
    """The held experts on the sorted assignments.  A grouped product
    leaves what it likes in the rows past the last offset (no held
    expert): the products' outputs are set to 0 there before anything reads
    them, and the gather and the combine leave those rows out, so neither
    pass reads them."""
    pad = ~keep[:, None]
    xs = _Gather.apply(x, order, k, keep)
    gu = torch._grouped_mm(xs, gate_up.transpose(-2, -1), offs=offs)
    gate, up = gu.masked_fill_(pad, 0).chunk(2, dim=-1)
    h = (F.silu(gate) * up * w[:, None]).masked_fill_(pad, 0)
    y = torch._grouped_mm(h, down.transpose(-2, -1), offs=offs)
    return _Combine.apply(y, order, k, keep)


def sort_assignments(key, w, held: int, dtype):
    """The assignments sorted by held expert (stable: a token's slots stay
    in order), those of no held expert last: (order, the rows each held
    expert takes (held,), whether each sorted row is held, the sorted
    weights in `dtype`)."""
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=key.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    keep = key.index_select(0, order) < held
    return (order, counts[:held], keep,
            w.reshape(-1).index_select(0, order).to(dtype))


def held_experts_grouped(x, order, counts, keep, ws, gate_up, down):
    """Each token's sum over its held assignments of `w * expert(x)`, by
    grouped products over the sorted rows (`sort_assignments`).  The
    inside is recomputed in the backward."""
    k = order.numel() // x.shape[0]
    offs = counts.cumsum(0).to(torch.int32)
    return checkpoint(_grouped_rows, x, order, keep, ws, offs, gate_up, down,
                      k, use_reentrant=False)


def held_experts_loop(x, order, counts, keep, ws, gate_up, down):
    """The same sum over the same sorted rows, one held expert at a time
    (each a host-sized slice: off the card's fast path)."""
    k = order.numel() // x.shape[0]
    xs = _Gather.apply(x, order, k, keep)
    parts, start = [], 0
    for e, rows in enumerate(counts.tolist()):
        gate, up = F.linear(xs[start:start + rows], gate_up[e]).chunk(2, -1)
        h = F.silu(gate) * up * ws[start:start + rows, None]
        parts.append(F.linear(h, down[e]))
        start += rows
    parts.append(xs.new_zeros(xs.shape[0] - start, xs.shape[1]))
    return _Combine.apply(torch.cat(parts), order, k, keep)


class HeldExperts(nn.Module):
    """This share's routed experts, stacked: `gate_up_proj` (E, 2 I, hidden)
    and `down_proj` (E, hidden, I)."""

    def __init__(self, cfg: GigaChatConfig):
        super().__init__()
        e, i, d = cfg.experts_held, cfg.moe_intermediate_size, cfg.hidden_size
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, d))
        self.down_proj = nn.Parameter(torch.empty(e, d, i))


class MoE(nn.Module):
    """`DeepseekV3MoE` on one expert-parallel share: the held experts by
    grouped products on a CUDA bf16 input, by the loop elsewhere."""

    def __init__(self, cfg: GigaChatConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = MoEGate(cfg)
        self.experts = HeldExperts(cfg)
        self.shared_experts = SwiGLU(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)
        self.rows = None  # (held,) int64 on the device: rows each expert took

    def forward(self, x, valid):
        """x (B, T, hidden), valid (B, T) bool -> (B, T, hidden)."""
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        ids, w = self.gate(flat)
        held = self.cfg.experts_held
        key = held_keys(ids, valid.reshape(-1), self.cfg.first_expert, held)
        order, counts, keep, ws = sort_assignments(key, w, held, x.dtype)
        if self.rows is None or self.rows.device != counts.device:
            self.rows = torch.zeros_like(counts)
        self.rows += counts
        fn = (held_experts_grouped
              if flat.is_cuda and flat.dtype == torch.bfloat16
              else held_experts_loop)
        routed = fn(flat, order, counts, keep, ws,
                    self.experts.gate_up_proj.to(x.dtype),
                    self.experts.down_proj.to(x.dtype))
        return routed.view(shape) + self.shared_experts(x)


# ---------------------------------------------------------------- the stack
class DecoderLayer(nn.Module):
    def __init__(self, cfg: GigaChatConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.moe = index >= cfg.first_k_dense_replace
        self.mlp = (MoE(cfg) if self.moe
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size))

    def forward(self, x, cos, sin, valid):
        n = self.input_layernorm(x)
        backward_mark(n, "backward.text")
        with span("forward.text.attention", device=True):
            a = self.self_attn(n, cos, sin)
            backward_mark(a, "backward.text.attention")
        h = x + a
        n = self.post_attention_layernorm(h)
        backward_mark(n, "backward.text")
        if self.moe:
            with span("forward.text.moe", device=True):
                f = self.mlp(n, valid)
                backward_mark(f, "backward.text.moe")
        else:
            f = self.mlp(n)
            backward_mark(f, "backward.text")
        return h + f


class GigaChatModel(nn.Module):
    """Embedding, the decoder layers, the final RMSNorm."""

    def __init__(self, cfg: GigaChatConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._rope = {}

    def rope(self, length: int, device):
        key = (length, str(device))
        if key not in self._rope:
            with torch.inference_mode(False), torch.no_grad():
                self._rope[key] = rope_tables(self.cfg, length, device)
        return self._rope[key]

    def forward(self, ids, valid):
        h = F.embedding(ids, self.embed_tokens.weight)
        cos, sin = self.rope(ids.shape[1], ids.device)
        for layer in self.layers:
            h = layer(h, cos, sin, valid)
        return self.norm(h)

    def expert_rows(self):
        """{layer index: (held,) int64 device tensor} of the MoE layers'
        row counts since they were built (or last cleared)."""
        return {i: layer.mlp.rows for i, layer in enumerate(self.layers)
                if layer.moe and layer.mlp.rows is not None}


class GigaChatTextExtractor(nn.Module):
    """The text tower of the multimodal model: (B, T) token ids and (B,)
    lengths -> (B, T, hidden) features, Linear(hidden_size -> hidden) and
    ReLU over the decoder's last output, zero at the pad positions.  The
    token embedding is frozen: the fine-tune trains the decoder and the
    adaptor and reads the vocabulary's table as loaded."""

    def __init__(self, config: GigaChatConfig = GIGACHAT3_1_EP32,
                 hidden_size: int = 768):
        super().__init__()
        self.model = GigaChatModel(config)
        self.model.embed_tokens.weight.requires_grad_(False)
        self.adaptor = Linear(config.hidden_size, hidden_size)

    def forward(self, ids, lengths: Optional[torch.Tensor] = None):
        t = ids.shape[1]
        if lengths is None:
            valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        else:
            valid = (torch.arange(t, device=ids.device)[None]
                     < lengths.to(ids.device)[:, None])
        h = torch.relu(self.adaptor(self.model(ids, valid)))
        return h * valid[..., None].to(h.dtype)
