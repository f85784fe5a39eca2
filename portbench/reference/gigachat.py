"""The plain reference of GigaChat3.1-702B-A36B's decoder as the text tower
of the audio,text PhysVerb model, in plain PyTorch.  It imports nothing of
the program and nothing of JAX, and sets TF32 off.

GigaChat3.1 (HuggingFace `ai-sage/GigaChat3.1-702B-A36B`, `model_type`
`deepseek_v3`), its sizes from the configuration's top-level keys (HF's
names), on one expert-parallel share, trained as the audio,text model's
text tower over transcript token ids:

- the token embedding (the whole vocabulary), frozen;
- each layer `h = x + MLA(RMSNorm(x))`, `out = h + FFN(RMSNorm(h))`, and
  a final RMSNorm; RMSNorm `x * rsqrt(mean(x^2) + eps) * w` in float32;
- MLA: `q = q_b(RMSNorm(q_a(x)))` split per head into 128 + 64;
  `[c, k_pe] = kv_a(x)`; `[k_nope, v] = kv_b(RMSNorm(c))` per head; the
  64-wide parts of q and of the one shared key de-interleaved
  (`view(..., 32, 2).transpose`) and rotated by `rotate_half` with the cos
  and sin of `cat(f, f)`, `f` the YaRN frequencies; softmax of `q k^T *
  scale` under an explicit causal mask, `scale = qk_head_dim^-1/2 *
  (0.1 ln(factor) + 1)^2`; `o_proj`; no bias anywhere;
- the first `first_k_dense_replace` layers' FFN `down(silu(gate(x)) *
  up(x))`; the others a mixture of experts: `s = sigmoid(x W^T)` in
  float32 over every routed expert; choice scores `s + b`; per group of
  experts the sum of its two best choice scores; the best `topk_group`
  groups kept and the other groups' choice scores set to 0; the best
  `num_experts_per_tok` experts; their `s` over (their sum + 1e-20), times
  `routed_scaling_factor`; the output the sum over the chosen experts held
  here of `w * expert(x)`, plus the shared expert's;
- the multimodal model's adaptor (not GigaChat's): Linear hidden -> 768,
  ReLU, the pad positions zeroed, whose tokens join the CNN1D audio tower's
  in the fusion encoder, heads and losses of `model.py`.

Departures from the published model:

- one chip's share of an expert-parallel deployment (`expert_parallel`
  32, `expert_rank` 0): each MoE layer holds `n_routed_experts` 8, experts
  0-7 of its 8 x 32 = 256 (the router's width), and adds only
  their part; the other shares' experts are left out, here as in the
  program;
- the depth is one pipeline stage: `num_hidden_layers` 5, of which
  `first_k_dense_replace` 1 dense;
- no LM head and no MTP module (a classification fine-tune has no
  next-token loss); the token embedding is frozen (the fine-tune trains
  the decoder and the adaptor; the table is read as loaded);
- pad positions (past each transcript's length) are never routed: they
  reach no expert; the batch is right-padded, so the causal mask keeps them
  from every valid query, and their features are zeroed;
- the correction bias `b` is frozen (published as a buffer that the
  auxiliary-loss-free balancing moves outside the gradient): no gradient;
- the weights are random from the run's seed.

The experts are a loop over the held experts, each on the rows that chose
it (by mask); no grouped product, no fused attention, no batching trick.
Every product goes through `model.Products`, so the reference computes in
float32 or rounds to the configuration's compute dtype, or one lower.  The
tower runs in blocks of clips (`GigaChatReferenceTrainer`): without a
gradient to give the fusion its tokens, then block by block again with
one, back-propagated from its rows of the tokens' gradient.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import model as M
from .train import ReferenceTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRE = "extractors.text"
DEC = f"{PRE}.model"
BIAS = "e_score_correction_bias"  # the router's frozen correction bias


def flagship(cfg):
    """The configuration as `model.py` reads it: the fusion's width under
    `hidden_size` (the top level holds GigaChat's)."""
    return {**cfg, "hidden_size": cfg["fusion_hidden_size"]}


def held(cfg):
    """(first expert id, number of experts) this share holds."""
    n = cfg["n_routed_experts"]
    return cfg["expert_rank"] * n, n


def router_experts(cfg) -> int:
    """The layer's routed experts over every share: the router's width."""
    return cfg["n_routed_experts"] * cfg["expert_parallel"]


# ---------------------------------------------------------------- structure
def parameter_spec(cfg, modalities):
    """[(name, shape, init)] of the text tower, then the rest of the model
    (`model.parameter_spec` at the fusion's width), in the program's
    names."""
    e, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    spec = []

    def linear(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in), ("uniform", n_in)))

    def norm(name, n):
        spec.append((f"{name}.weight", (n,), "norm_weight"))

    def swiglu(name, width):
        linear(f"{name}.gate_proj", e, width)
        linear(f"{name}.up_proj", e, width)
        linear(f"{name}.down_proj", width, e)

    spec.append((f"{DEC}.embed_tokens.weight", (cfg["vocab_size"], e),
                 ("uniform", 1)))
    _, n_held = held(cfg)
    width = cfg["moe_intermediate_size"]
    for i in range(cfg["num_hidden_layers"]):
        layer = f"{DEC}.layers.{i}"
        norm(f"{layer}.input_layernorm", e)
        a = f"{layer}.self_attn"
        linear(f"{a}.q_a_proj", e, cfg["q_lora_rank"])
        norm(f"{a}.q_a_layernorm", cfg["q_lora_rank"])
        linear(f"{a}.q_b_proj", cfg["q_lora_rank"], heads * (nope + rope))
        linear(f"{a}.kv_a_proj_with_mqa", e, cfg["kv_lora_rank"] + rope)
        norm(f"{a}.kv_a_layernorm", cfg["kv_lora_rank"])
        linear(f"{a}.kv_b_proj", cfg["kv_lora_rank"], heads * (nope + vd))
        linear(f"{a}.o_proj", heads * vd, e)
        norm(f"{layer}.post_attention_layernorm", e)
        if i < cfg["first_k_dense_replace"]:
            swiglu(f"{layer}.mlp", cfg["intermediate_size"])
            continue
        spec.append((f"{layer}.mlp.gate.weight", (router_experts(cfg), e),
                     ("uniform", e)))
        spec.append((f"{layer}.mlp.gate.{BIAS}", (router_experts(cfg),),
                     "norm_bias"))
        spec.append((f"{layer}.mlp.experts.gate_up_proj",
                     (n_held, 2 * width, e), ("uniform", e)))
        spec.append((f"{layer}.mlp.experts.down_proj", (n_held, e, width),
                     ("uniform", width)))
        swiglu(f"{layer}.mlp.shared_experts",
               width * cfg["n_shared_experts"])
    norm(f"{DEC}.norm", e)
    out = cfg["fusion_hidden_size"]
    spec.append((f"{PRE}.adaptor.weight", (out, e), ("uniform", e)))
    spec.append((f"{PRE}.adaptor.bias", (out,), ("uniform", e)))
    return spec + M.parameter_spec(flagship(cfg), modalities)


def is_trainable(name: str) -> bool:
    return not (M.is_buffer(name) or name.endswith(BIAS)
                or name == f"{DEC}.embed_tokens.weight")


def mask_shapes(cfg, modalities, batch: int):
    """The step's draws: the flagship's (the text tower draws none)."""
    return M.mask_shapes(flagship(cfg), modalities, batch, False)


def draw_masks(generator, cfg, modalities, batch: int, device):
    return M.draw_masks(generator, flagship(cfg), modalities, batch, False,
                        device)


# ---------------------------------------------------------------- RoPE
def yarn_mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg):
    """The YaRN inverse frequencies, float64 numbers (`deepseek_v3`'s
    `DeepseekV3YarnRotaryEmbedding`)."""
    s, d, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], cfg["rope_theta"]
    original = s["original_max_position_embeddings"]

    def corr(rot):
        return d * math.log(original / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(s["beta_fast"])), 0)
    high = min(math.ceil(corr(s["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    out = []
    for i in range(d // 2):
        extra = base ** (-2 * i / d)
        mask = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(extra / s["factor"] * (1 - mask) + extra * mask)
    return out


def attention_scale(cfg):
    s = cfg["rope_scaling"]
    m = yarn_mscale(s["factor"], s["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_tables(cfg, t: int, device):
    s = cfg["rope_scaling"]
    scale = (yarn_mscale(s["factor"], s["mscale"])
             / yarn_mscale(s["factor"], s["mscale_all_dim"]))
    inv = torch.tensor(yarn_inv_freq(cfg), dtype=torch.float64)
    freqs = torch.outer(torch.arange(t, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return ((emb.cos() * scale).float().to(device),
            (emb.sin() * scale).float().to(device))


def rope(x, cos, sin, prod):
    """x (B, T, heads, d): de-interleave, then x cos + rotate_half(x) sin."""
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2).transpose(3, 4).reshape(b, t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return prod.s(x * cos[:, None] + rot * sin[:, None])


# ---------------------------------------------------------------- the tower
def rms(x, w, eps, prod):
    return prod.s(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
                  * w)


def mla(x, p, a, cfg, cos, sin, prod):
    b, t, _ = x.shape
    heads, nope, rp = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                       cfg["qk_rope_head_dim"])
    eps = cfg["rms_norm_eps"]
    q = prod.linear(rms(prod.linear(x, p[f"{a}.q_a_proj.weight"]),
                        p[f"{a}.q_a_layernorm.weight"], eps, prod),
                    p[f"{a}.q_b_proj.weight"]).view(b, t, heads, nope + rp)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = prod.linear(x, p[f"{a}.kv_a_proj_with_mqa.weight"])
    c, k_pe = ckv[..., :cfg["kv_lora_rank"]], ckv[..., cfg["kv_lora_rank"]:]
    kv = prod.linear(rms(c, p[f"{a}.kv_a_layernorm.weight"], eps, prod),
                     p[f"{a}.kv_b_proj.weight"]).view(b, t, heads, -1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, rope(q_pe, cos, sin, prod)], dim=-1)
    k_pe = rope(k_pe.reshape(b, t, 1, rp), cos, sin, prod)
    k = torch.cat([k_nope, k_pe.expand(b, t, heads, rp)], dim=-1)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    scores = prod.scores(q, k) * attention_scale(cfg)
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    probs = torch.softmax(scores + causal, dim=-1)
    out = prod.matmul(probs, v).transpose(1, 2).reshape(b, t, -1)
    return prod.linear(out, p[f"{a}.o_proj.weight"])


def swiglu(x, p, name, prod):
    g = prod.linear(x, p[f"{name}.gate_proj.weight"])
    u = prod.linear(x, p[f"{name}.up_proj.weight"])
    return prod.linear(prod.s(F.silu(g) * u), p[f"{name}.down_proj.weight"])


def route(x, weight, bias, cfg, prod):
    """(chosen ids (N, k), their weights (N, k)) of tokens x (N, hidden)."""
    s = torch.sigmoid(F.linear(x, prod.r(weight)))
    n, experts = s.shape
    groups, k = cfg["n_group"], cfg["num_experts_per_tok"]
    choice = (s + bias).detach()
    group_scores = choice.view(n, groups, -1).topk(2, dim=-1).values.sum(-1)
    best = group_scores.topk(cfg["topk_group"], dim=-1).indices
    keep = torch.zeros_like(group_scores).scatter(1, best, 1.0) > 0
    keep = keep[:, :, None].expand(n, groups, experts // groups)
    choice = torch.where(keep.reshape(n, experts), choice, 0.0)
    ids = choice.topk(k, dim=-1).indices
    w = s.gather(1, ids)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids, w * cfg["routed_scaling_factor"]


def expected_rows(cfg, valid_tokens: float) -> int:
    """A held expert's rows on meta tensors (routing needs values): its
    share of the valid tokens' assignments."""
    return max(1, round(valid_tokens * cfg["num_experts_per_tok"]
                        / router_experts(cfg)))


def moe(x, valid, p, name, cfg, prod, meta_rows=None):
    """x (B, T, hidden), valid (B, T) -> the held experts' part plus the
    shared expert's."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    ids, w = route(flat, p[f"{name}.gate.weight"], p[f"{name}.gate.{BIAS}"],
                   cfg, prod)
    first, n_held = held(cfg)
    width = cfg["moe_intermediate_size"]
    out = torch.zeros_like(flat)
    for e in range(n_held):
        chosen = (ids == first + e) & valid.reshape(-1, 1)
        if flat.is_meta:
            rows = torch.empty(meta_rows, dtype=torch.int64, device="meta")
        else:
            rows = chosen.any(-1).nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
        we = (w * chosen).sum(-1)[rows]
        gate_up = p[f"{name}.experts.gate_up_proj"][e]
        gu = prod.linear(flat[rows], gate_up)
        h = prod.s(F.silu(gu[:, :width]) * gu[:, width:])
        y = prod.linear(h, p[f"{name}.experts.down_proj"][e])
        out = out.index_add(0, rows, we[:, None] * y)
    routed = prod.s(out).view(shape)
    return prod.s(routed + swiglu(x, p, f"{name}.shared_experts", prod))


def tower(ids, lengths, p, cfg, prod, meta_rows=None):
    """(B', T) token ids and their lengths -> (B', T, 768) features."""
    b, t = ids.shape
    eps = cfg["rms_norm_eps"]
    valid = torch.arange(t, device=ids.device)[None] < lengths[:, None]
    h = prod.s(F.embedding(ids, p[f"{DEC}.embed_tokens.weight"]))
    cos, sin = (prod.s(z) for z in rope_tables(cfg, t, ids.device))
    for i in range(cfg["num_hidden_layers"]):
        layer = f"{DEC}.layers.{i}"
        n = rms(h, p[f"{layer}.input_layernorm.weight"], eps, prod)
        h = prod.s(h + mla(n, p, f"{layer}.self_attn", cfg, cos, sin, prod))
        n = rms(h, p[f"{layer}.post_attention_layernorm.weight"], eps, prod)
        if i < cfg["first_k_dense_replace"]:
            f = swiglu(n, p, f"{layer}.mlp", prod)
        else:
            f = moe(n, valid, p, f"{layer}.mlp", cfg, prod, meta_rows)
        h = prod.s(h + f)
    h = rms(h, p[f"{DEC}.norm.weight"], eps, prod)
    f = torch.relu(prod.linear(h, p[f"{PRE}.adaptor.weight"],
                               p[f"{PRE}.adaptor.bias"]))
    return f * valid[..., None]


# ---------------------------------------------------------------- training
class GigaChatReferenceTrainer(ReferenceTrainer):
    """`train.ReferenceTrainer`'s Adam and step over the GigaChat
    audio,text model: every leaf trains but the token embedding, the
    correction biases (and the CNN1D's BatchNorm statistics); the tower runs in blocks of `row_block`
    clips, each block's gradient added into the leaves' `.grad`."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg, modalities,
                 lr: float = 1e-3, products: Optional[str] = None,
                 row_block: int = 2, meta_rows: Optional[int] = None):
        self.cfg, self.modalities = cfg, tuple(sorted(modalities))
        self.view = flagship(cfg)
        self.prod = M.Products(products)
        self.lr, self.row_block, self.meta_rows = lr, row_block, meta_rows
        self.params = {n: w.detach().clone().float()
                       for n, w in weights.items() if not M.is_buffer(n)}
        self.trainable = [n for n in self.params if is_trainable(n)]
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.t = 0

    def _tower(self, ids, lengths, p):
        return tower(ids, lengths, p, self.cfg, self.prod, self.meta_rows)

    def loss_and_grads(self, batch, masks, whole: bool = False):
        """(loss, {name: gradient}) of one batch.  `whole` runs the tower on
        every clip at once inside the one backward (on the meta device, to
        count operations)."""
        mods = batch["modalities"]
        ids, lengths = mods["text"]["data"], mods["text"]["lengths"]
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in self.trainable}
        p = dict(self.params)
        p.update(leaves)
        names = [n for n in self.trainable if n.startswith(PRE + ".")]
        blocks = [slice(r, min(ids.shape[0], r + self.row_block))
                  for r in range(0, ids.shape[0], self.row_block)]
        if whole:
            text = self._tower(ids, lengths, p)
            text_leaf = None
        else:
            with torch.no_grad():
                text = torch.cat([self._tower(ids[r], lengths[r], self.params)
                                  for r in blocks])
            text_leaf = text.requires_grad_(True)
        feats = {"text": text}
        if "audio" in self.modalities:
            feats["audio"] = M.audio_tower(mods["audio"]["data"], p, masks,
                                           self.prod)
        for m in feats:
            present = mods[m]["present"]
            feats[m] = feats[m] * present[:, None, None].to(feats[m].dtype)
        logits = M.heads_logits(feats, p, self.view, masks, self.prod)
        loss = M.total_loss({h: lg.float() for h, lg in logits.items()},
                            batch, self.cfg["focal_alpha"],
                            self.cfg["focal_gamma"])
        wrt = [n for n in self.trainable if whole or n not in names]
        targets = [leaves[n] for n in wrt]
        if text_leaf is not None:
            targets.append(text_leaf)
        grads = torch.autograd.grad(loss, targets, allow_unused=True)
        out = {n: (torch.zeros_like(self.params[n]) if g is None else g)
               for n, g in zip(wrt, grads)}
        if text_leaf is not None:
            grad = grads[-1]
            del grads, text_leaf, feats, logits
            tower_leaves = {n: self.params[n].detach().requires_grad_(True)
                            for n in names}
            tp = dict(self.params)
            tp.update(tower_leaves)
            for r in blocks:
                self._tower(ids[r], lengths[r], tp).backward(grad[r])
            out.update({n: (torch.zeros_like(self.params[n]) if t.grad is None
                            else t.grad) for n, t in tower_leaves.items()})
        return loss.detach(), out
