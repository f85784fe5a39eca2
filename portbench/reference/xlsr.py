"""The plain reference of XLS-R 300M as the audio tower of the audio,text
PhysVerb model, in plain PyTorch.  It imports nothing of the program and
nothing of JAX, and sets TF32 off.

XLS-R 300M (Babu et al., "XLS-R", arXiv:2111.09296; HuggingFace
`facebook/wav2vec2-xls-r-300m`, `Wav2Vec2Model` with
`do_stable_layer_norm`), its sizes from the configuration's `xlsr` group
(HF's names), trained as it is fine-tuned:

- feature encoder, frozen (no gradient): seven convs with bias, 512
  channels, kernels (10, 3, 3, 3, 3, 2, 2), strides (5, 2, 2, 2, 2, 2, 2),
  each followed by a LayerNorm over the channels (eps 1e-5) and the exact
  GELU (`feat_extract_norm` "layer");
- feature projection: LayerNorm(512), Linear 512->1024, dropout 0.1;
- time masking: each clip's spans of 10 frames take the learned 1024-wide
  `masked_spec_embed` (`time_mask`);
- positional embedding: a grouped Conv1d 1024->1024, kernel 128, 16
  groups (here 16 convs of 64 channels), padding 64, its weight normed
  over all but the kernel axis
  (weight_g * weight_v / |weight_v|), the last frame dropped, the exact
  GELU, added to its input; dropout 0.1;
- 24 pre-LN layers: LayerNorm, 16-head self-attention (d 64, the weights'
  dropout 0.1), dropout 0.1, residual; LayerNorm, Linear 1024->4096, exact
  GELU, dropout 0.0, Linear 4096->1024, dropout 0.1, residual; a final
  LayerNorm;
- the multimodal model's adaptor (not XLS-R's): Linear 1024->768, ReLU,
  dropout 0.3, whose tokens join the text tokens in the fusion encoder,
  heads and losses of `model.py`.

Departures from the published description:

- LayerDrop (0.1 as published) is 0: every step runs the 24 layers (the
  configuration's `changed`);
- the time mask's draws are the step's own: per clip one uniform `u` for
  the count floor(0.075 T / 10 + u) (at least 2, at most what the frames
  hold) and one uniform key per start; the starts are the positions of the
  largest keys, the lower position first among equal keys: distinct and
  uniform over [0, T - 10], as HF's numpy draw is;
- the attention's scores are (q k^T) / sqrt(d), as the program computes
  them, where HF scales q first: the same function;
- the weights are random from the run's seed, `masked_spec_embed` and the
  weight norm's g included (HF: U[0, 1) and |v|).

Every random draw comes from the `masks` a step is handed, and every
product goes through `model.Products`, so the reference computes in f32 or
rounds to the configuration's compute dtype as `model.py` does.  The tower
runs in blocks of clips (`XlsrReferenceTrainer`): the frozen features once,
the rest of the tower without a gradient to give the fusion its tokens,
then block by block again with one, back-propagated from its rows of the
tokens' gradient.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import model as M
from .train import ReferenceTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRE = "extractors.audio"
ENC = f"{PRE}.encoder"
FROZEN = f"{ENC}.feature_extractor."  # the frozen conv encoder's leaves
EPS = 1e-5


# ---------------------------------------------------------------- structure
def frames(cfg) -> int:
    """The conv stack's output frames for the clip."""
    t = cfg["audio_samples"]
    for k, s in zip(cfg["xlsr"]["conv_kernel"], cfg["xlsr"]["conv_stride"]):
        t = (t - k) // s + 1
    return t


def feature_tokens(cfg, modalities):
    out = {"audio": frames(cfg)}
    if "text" in modalities:
        out["text"] = cfg["text_tokens"]
    return out


def parameter_spec(cfg, modalities):
    """[(name, shape, init)] of the tower, then the rest of the model
    (`model.parameter_spec` without its CNN1D), in the program's names."""
    x = cfg["xlsr"]
    e, ff = x["hidden_size"], x["intermediate_size"]
    spec = []

    def linear(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in), ("uniform", n_in)))
        spec.append((f"{name}.bias", (n_out,), ("uniform", n_in)))

    def norm(name, n):
        spec.append((f"{name}.weight", (n,), "norm_weight"))
        spec.append((f"{name}.bias", (n,), "norm_bias"))

    spec.append((f"{ENC}.masked_spec_embed", (e,), ("uniform", 1)))
    c_in = 1
    for i, (c, k) in enumerate(zip(x["conv_dim"], x["conv_kernel"])):
        spec.append((f"{FROZEN}conv{i}.weight", (c, c_in, k),
                     ("uniform", c_in * k)))
        spec.append((f"{FROZEN}conv{i}.bias", (c,), ("uniform", c_in * k)))
        norm(f"{FROZEN}norm{i}", c)
        c_in = c
    norm(f"{ENC}.fp_norm", c_in)
    linear(f"{ENC}.fp_proj", c_in, e)
    k = x["num_conv_pos_embeddings"]
    groups = x["num_conv_pos_embedding_groups"]
    spec.append((f"{ENC}.pos_conv.weight_v", (e, e // groups, k),
                 ("uniform", e // groups * k)))
    spec.append((f"{ENC}.pos_conv.weight_g", (1, 1, k), "norm_weight"))
    spec.append((f"{ENC}.pos_conv.bias", (e,), ("uniform", e // groups * k)))
    norm(f"{ENC}.encoder_norm", e)
    for i in range(x["num_hidden_layers"]):
        layer = f"{ENC}.layers.{i}"
        spec.append((f"{layer}.self_attn.in_proj_weight", (3 * e, e),
                     ("xavier", 4 * e)))
        spec.append((f"{layer}.self_attn.in_proj_bias", (3 * e,), "zeros"))
        spec.append((f"{layer}.self_attn.out_proj.weight", (e, e),
                     ("uniform", e)))
        spec.append((f"{layer}.self_attn.out_proj.bias", (e,), "zeros"))
        linear(f"{layer}.linear1", e, ff)
        linear(f"{layer}.linear2", ff, e)
        norm(f"{layer}.norm1", e)
        norm(f"{layer}.norm2", e)
    linear(f"{PRE}.adaptor", e, cfg["hidden_size"])
    return spec + [s for s in M.parameter_spec(cfg, modalities)
                   if not s[0].startswith(PRE + ".")]


# ---------------------------------------------------------------- the draws
def mask_shapes(cfg, modalities, batch: int):
    """[(key, shape, rate)] of one step's draws, in the order the program
    takes them: the projection's dropout, the time mask's uniforms (count,
    then keys; rate None), the dropout after the positional embedding,
    each layer's attention, residual, activation (where its rate is not
    0) and feed-forward dropouts, the adaptor's, then the fusion layers',
    the adaptors' in modality order and the heads', as `model.py` has
    them."""
    x = cfg["xlsr"]
    e, t = x["hidden_size"], frames(cfg)
    out = [("xlsr.proj", (batch, t, e), x["feat_proj_dropout"]),
           ("xlsr.mask_count", (batch,), None),
           ("xlsr.mask_keys", (batch, t - x["mask_time_length"] + 1), None),
           ("xlsr.pos", (batch, t, e), x["hidden_dropout"])]
    heads = x["num_attention_heads"]
    for i in range(x["num_hidden_layers"]):
        out.append((f"xlsr{i}.attn", (batch, heads, t, t),
                    x["attention_dropout"]))
        out.append((f"xlsr{i}.res1", (batch, t, e), x["hidden_dropout"]))
        if x["activation_dropout"] > 0:
            out.append((f"xlsr{i}.act", (batch, t, x["intermediate_size"]),
                        x["activation_dropout"]))
        out.append((f"xlsr{i}.res2", (batch, t, e), x["hidden_dropout"]))
    hidden = cfg["hidden_size"]
    out.append(("audio.adaptor", (batch, t, hidden), 0.3))
    tokens = feature_tokens(cfg, modalities)
    total = sum(tokens.values())
    for i in range(cfg["fusion_layers"]):
        out.append((f"fusion{i}.attn", (batch, cfg["fusion_heads"], total,
                                        total), 0.1))
        out.append((f"fusion{i}.res1", (batch, total, hidden), 0.1))
        out.append((f"fusion{i}.ff", (batch, total, cfg["fusion_ff"]), 0.1))
        out.append((f"fusion{i}.res2", (batch, total, hidden), 0.1))
    for m in sorted(tokens):
        out.append((f"adaptor.{m}", (batch, tokens[m], cfg["adaptor_out"]),
                    0.3))
    width = cfg["adaptor_out"] * len(tokens)
    for head in M.HEADS:
        out.append((f"head.{head}", (batch, width // 3), 0.3))
    return out


def draw_masks(generator, cfg, modalities, batch: int, device):
    """{key: (uniforms, rate)}: one `torch.rand` per draw, from
    `generator` in the program's order."""
    return {key: (torch.rand(shape, generator=generator, device=device), rate)
            for key, shape, rate in mask_shapes(cfg, modalities, batch)}


def time_mask(u, keys, x):
    """(B, T) bool: the frames each clip's time-mask spans cover, worked
    out clip by clip from its count uniform `u` and its start keys."""
    length = x["mask_time_length"]
    b, starts = keys.shape
    t = starts + length - 1
    if keys.is_meta:  # counting operations: no values to mask by
        return torch.empty((b, t), dtype=torch.bool, device="meta")
    u, keys = u.cpu(), keys.cpu()
    mask = torch.zeros(b, t, dtype=torch.bool)
    for i in range(b):
        row = keys[i].tolist()
        order = sorted(range(starts), key=lambda j: (-row[j], j))
        for s in order[:span_count(u[i], t, x)]:
            mask[i, s:s + length] = True
    return mask


def span_count(u, t: int, x) -> int:
    """A clip of `t` frames' number of spans from its uniform `u` (a
    float32 tensor, summed in float32 as it is drawn): floor(prob * t /
    length + u), at least `mask_time_min_masks`, at most what the frames
    hold."""
    length = x["mask_time_length"]
    n = int(torch.floor(x["mask_time_prob"] * t / length + u))
    return min(max(n, x["mask_time_min_masks"]), t // length,
               t - length + 1)


# ---------------------------------------------------------------- the tower
def conv_features(wave, p, cfg, prod):
    """(B, L) waveform -> (B, T, 512): the frozen conv encoder."""
    x = cfg["xlsr"]
    h = prod.s(wave)[:, None, :]
    for i, s in enumerate(x["conv_stride"]):
        h = prod.conv1d(h, p[f"{FROZEN}conv{i}.weight"],
                        p[f"{FROZEN}conv{i}.bias"], s, 0)
        h = prod.layer_norm(h.transpose(1, 2), p, f"{FROZEN}norm{i}", EPS)
        h = prod.s(F.gelu(h)).transpose(1, 2)
    return h.transpose(1, 2)


def _attention(h, p, layer, heads, drop, prod):
    """Self-attention of layer `layer`; `drop(probs)` its weights'
    dropout."""
    b, t, e = h.shape
    d = e // heads
    qkv = prod.linear(h, p[f"{layer}.self_attn.in_proj_weight"],
                      p[f"{layer}.self_attn.in_proj_bias"])
    q, k, v = qkv.view(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    probs = torch.softmax(prod.scores(q, k) / math.sqrt(d), dim=-1)
    out = prod.matmul(drop(probs), v)
    return prod.linear(out.transpose(1, 2).reshape(b, t, e),
                       p[f"{layer}.self_attn.out_proj.weight"],
                       p[f"{layer}.self_attn.out_proj.bias"])


def tower(conv, p, cfg, masks, rows, prod):
    """The frozen features `conv` (B', T, 512) of clips `rows` -> their
    (B', T, hidden) tokens, train mode."""
    x = cfg["xlsr"]

    def drop(h, key):
        u, rate = masks[key]
        return prod.dropout(h, u[rows], rate)

    h = prod.layer_norm(conv, p, f"{ENC}.fp_norm", EPS)
    h = drop(prod.linear(h, p[f"{ENC}.fp_proj.weight"],
                         p[f"{ENC}.fp_proj.bias"]), "xlsr.proj")
    mask = time_mask(masks["xlsr.mask_count"][0][rows],
                     masks["xlsr.mask_keys"][0][rows], x).to(h.device)
    h = prod.s(torch.where(mask[..., None], p[f"{ENC}.masked_spec_embed"], h))
    v = p[f"{ENC}.pos_conv.weight_v"]
    weight = p[f"{ENC}.pos_conv.weight_g"] * v / torch.linalg.vector_norm(
        v, dim=(0, 1), keepdim=True)
    k = x["num_conv_pos_embeddings"]
    # each group a conv of its own (the operation counter takes a grouped
    # conv's backward for `groups` times its work)
    c = v.shape[1]
    inp, weight = prod.r(h.transpose(1, 2)), prod.r(weight)
    bias = p[f"{ENC}.pos_conv.bias"]
    pos = prod.s(torch.cat([
        F.conv1d(inp[:, j:j + c], weight[j:j + c], bias[j:j + c],
                 padding=k // 2) for j in range(0, v.shape[0], c)], dim=1))
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = drop(prod.s(h + prod.s(F.gelu(pos.transpose(1, 2)))), "xlsr.pos")
    for i in range(x["num_hidden_layers"]):
        layer = f"{ENC}.layers.{i}"
        a = _attention(prod.layer_norm(h, p, f"{layer}.norm1", EPS), p, layer,
                       x["num_attention_heads"],
                       lambda a, i=i: drop(a, f"xlsr{i}.attn"), prod)
        h = prod.s(h + drop(a, f"xlsr{i}.res1"))
        f = prod.linear(prod.layer_norm(h, p, f"{layer}.norm2", EPS),
                        p[f"{layer}.linear1.weight"],
                        p[f"{layer}.linear1.bias"])
        f = prod.s(F.gelu(f))
        if x["activation_dropout"] > 0:
            f = drop(f, f"xlsr{i}.act")
        f = prod.linear(f, p[f"{layer}.linear2.weight"],
                        p[f"{layer}.linear2.bias"])
        h = prod.s(h + drop(f, f"xlsr{i}.res2"))
    h = prod.layer_norm(h, p, f"{ENC}.encoder_norm", EPS)
    h = torch.relu(prod.linear(h, p[f"{PRE}.adaptor.weight"],
                               p[f"{PRE}.adaptor.bias"]))
    return drop(h, "audio.adaptor")


# ---------------------------------------------------------------- training
class XlsrReferenceTrainer(ReferenceTrainer):
    """`train.ReferenceTrainer`'s Adam and step over the XLS-R audio,text
    model: every leaf trains but the frozen conv encoder's; the tower runs
    in blocks of `row_block` clips."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg, modalities,
                 lr: float = 1e-3, products: Optional[str] = None,
                 row_block: int = 4):
        self.cfg, self.modalities = cfg, tuple(sorted(modalities))
        self.prod = M.Products(products)
        self.lr, self.row_block = lr, row_block
        self.params = {n: w.detach().clone().float()
                       for n, w in weights.items()}
        self.trainable = [n for n in self.params if not n.startswith(FROZEN)]
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.t = 0

    def _blocks(self, batch: int):
        return [slice(r, min(batch, r + self.row_block))
                for r in range(0, batch, self.row_block)]

    def loss_and_grads(self, batch, masks, whole: bool = False):
        """(loss, {name: gradient}) of one batch.  `whole` runs the tower
        on every clip at once inside the one backward (on the meta device,
        to count operations)."""
        mods = batch["modalities"]
        wave = mods["audio"]["data"]
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in self.trainable}
        p = dict(self.params)
        p.update(leaves)
        tower_names = [n for n in self.trainable if n.startswith(PRE + ".")]
        with torch.no_grad():
            conv = conv_features(wave, self.params, self.cfg, self.prod)
        if whole:
            audio = tower(conv, p, self.cfg, masks, slice(None), self.prod)
            audio_leaf = None
        else:
            with torch.no_grad():
                audio = torch.cat([tower(conv[r], self.params, self.cfg,
                                         masks, r, self.prod)
                                   for r in self._blocks(wave.shape[0])])
            audio_leaf = audio.requires_grad_(True)
        feats = {"audio": audio}
        if "text" in self.modalities:
            feats["text"] = mods["text"]["data"]
        for m in feats:
            present = mods[m]["present"]
            feats[m] = feats[m] * present[:, None, None].to(feats[m].dtype)
        logits = M.heads_logits(feats, p, self.cfg, masks, self.prod)
        loss = M.total_loss({h: lg.float() for h, lg in logits.items()},
                            batch, self.cfg["focal_alpha"],
                            self.cfg["focal_gamma"])
        wrt = [n for n in self.trainable
               if whole or not n.startswith(PRE + ".")]
        targets = [leaves[n] for n in wrt]
        if audio_leaf is not None:
            targets.append(audio_leaf)
        grads = torch.autograd.grad(loss, targets, allow_unused=True)
        out = {n: (torch.zeros_like(self.params[n]) if g is None else g)
               for n, g in zip(wrt, grads)}
        if audio_leaf is not None:
            out.update(self._tower_backward(conv, masks, grads[-1],
                                            tower_names))
        return loss.detach(), out

    def _tower_backward(self, conv, masks, grad, names):
        """The tower's leaves' gradients from d loss / d tokens `grad`,
        block by block."""
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in names}
        p = dict(self.params)
        p.update(leaves)
        total = {n: torch.zeros_like(self.params[n]) for n in names}
        for r in self._blocks(conv.shape[0]):
            out = tower(conv[r], p, self.cfg, masks, r, self.prod)
            for n, g in zip(names, torch.autograd.grad(
                    out, [leaves[n] for n in names], grad[r],
                    allow_unused=True)):
                if g is not None:
                    total[n] += g
        return total
