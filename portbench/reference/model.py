"""The plain reference of the multimodal PhysVerb model, in plain PyTorch.

It follows the published architecture and imports nothing of the program:

- audio: a raw-waveform 1-D CNN (stem Conv 1->64, k160, s40, p80; four
  blocks of two k3 convs, 64-128-256-512 channels), each conv followed by a
  train-mode BatchNorm (batch statistics, biased variance, eps 1e-5) and a
  ReLU, MaxPool(4) after the first four blocks, channel dropout (p 0.1)
  after every block; then Linear 512->768, ReLU, dropout (p 0.3);
- text: 48 token embeddings of width 768, taken as they are;
- video: torchvision's `swin3d_t` (Liu et al., "Video Swin Transformer",
  arXiv:2106.13230) without its head, on 8-frame windows of the clip folded
  into the batch: patch embedding Conv3d 3->96 (2, 4, 4), LayerNorm,
  stages of depths 2-2-6-2 and heads 3-6-12-24 with (shifted) window
  attention over (8, 7, 7) windows and a learned relative-position bias,
  patch merging between stages, final LayerNorm, mean over the grid; row
  stochastic depth rising linearly to 0.2 over the blocks (torchvision's
  `swin3d_t` uses 0.1: a departure the configuration file states);
- fusion: the modalities' tokens concatenated in name order, a token whose
  features sum to exactly zero masked as a key, one post-LN transformer
  encoder layer (768 wide, 8 heads, feed-forward 2048 with ReLU, dropout
  0.1) and a final LayerNorm;
- heads: per modality Linear 768->256, dropout (p 0.3), ReLU and a mean
  over its tokens; the concatenation feeds each of the `phys` and `verb`
  heads, Linear(D, D/3), ReLU, dropout (p 0.3), Linear(D/3, 2);
- losses: a focal loss (gamma 2, class weights alpha on the CE term) on
  `phys` and cross-entropy on `verb`, each a mean over the rows whose label
  is present, summed.

Where torchvision's Swin slices the full window's relative-position index
to a clamped window's first N tokens (`relative_position_index[:N, :N]`),
this reference does the same.

Every random draw is taken from the `masks` a step is handed
(`draw_masks`), so the reference can compute in any order and in blocks of
rows.  Every product (Linear, convolution, batched matmul) goes through
`Products`, which computes in float32 or rounds to a lower precision: the
configuration's compute dtype in a bf16 cell, and the control of the
output check one precision below.  Parameters carry the names of the program's state
dict, so one state dict made by the benchmark loads into both.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

CNN1D_BLOCKS = (((64, 160, 40, 80),),
                ((64, 3, 1, 1), (64, 3, 1, 1)),
                ((128, 3, 1, 1), (128, 3, 1, 1)),
                ((256, 3, 1, 1), (256, 3, 1, 1)),
                ((512, 3, 1, 1), (512, 3, 1, 1)))
HEADS = ("phys", "verb")  # the order the heads draw their dropout in


# ---------------------------------------------------------------- precision
def _round_tf32(t):
    """Round f32 to TF32's 10 mantissa bits (to nearest, ties away)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(t):
    """Scale the tensor's largest magnitude to e4m3's 448, round to
    float8_e4m3fn and back."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


ROUNDERS = {"bf16": lambda t: t.to(torch.bfloat16).to(t.dtype),
            "tf32": _round_tf32, "fp8": _round_fp8}


class _Round(torch.autograd.Function):
    """Round the operand in the forward and its gradient in the backward."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return ROUNDERS[mode](t)

    @staticmethod
    def backward(ctx, g):
        return ROUNDERS[ctx.mode](g), None


STORED = ("bf16", "fp8")  # compute dtypes: activations are stored in them


class Products:
    """The precision the reference computes in.  None: float32 (TF32 off).
    "tf32": the products' operands rounded to TF32, float32 elsewhere.
    "bf16" and "fp8" are compute dtypes, as a mixed-precision step runs
    them: the products' operands and every activation a layer returns are
    rounded to the dtype (`s`), while products accumulate and LayerNorm,
    BatchNorm, softmax and the losses compute in float32, and the
    parameters stay float32 masters."""

    def __init__(self, mode: Optional[str] = None):
        if mode is not None and mode not in ROUNDERS:
            raise ValueError(f"unknown product precision {mode!r}")
        self.mode = mode

    def r(self, t):
        """An operand of a product."""
        return t if self.mode is None or t is None else _Round.apply(
            t, self.mode)

    def s(self, t):
        """An activation as a layer returns it."""
        return _Round.apply(t, self.mode) if self.mode in STORED else t

    def linear(self, x, w, b=None):
        return self.s(F.linear(self.r(x), self.r(w), b))

    def matmul(self, a, b):
        return self.s(self.r(a) @ self.r(b))

    def conv1d(self, x, w, b, stride, padding):
        return self.s(F.conv1d(self.r(x), self.r(w), b, stride=stride,
                               padding=padding))

    def conv3d(self, x, w, b, stride):
        return self.s(F.conv3d(self.r(x), self.r(w), b, stride=stride))

    def scores(self, q, k):
        """q k^T, kept in float32 (attention scores are not stored); under
        a compute dtype q and k are stored values already."""
        if self.mode in STORED:
            return q @ k.transpose(-1, -2)
        return self.r(q) @ self.r(k).transpose(-1, -2)

    def dropout(self, x, u, rate):
        """Keep where the uniform `u` (broadcast over x) is below
        1 - rate, scaled by 1 / (1 - rate)."""
        keep = 1.0 - rate
        return self.s(torch.where(u < keep, x / keep, torch.zeros(
            (), dtype=x.dtype, device=x.device)))

    def layer_norm(self, x, p, name, eps=1e-5):
        return self.s(F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                                   p[f"{name}.bias"], eps))


# ---------------------------------------------------------------- structure
def audio_tokens(samples: int) -> int:
    t = samples // 40 + 1
    for _ in range(4):
        t //= 4
    return t


def swin_stages(cfg):
    """[(dim, heads, depth)] of the Swin tower."""
    dims = [cfg["swin_embed_dim"] * 2 ** i for i in range(len(cfg["swin_depths"]))]
    return list(zip(dims, cfg["swin_heads"], cfg["swin_depths"]))


def swin_block_rates(cfg):
    depths = cfg["swin_depths"]
    total = sum(depths)
    return [cfg["swin_stochastic_depth_prob"] * i / max(total - 1, 1)
            for i in range(total)]


def parameter_spec(cfg, modalities):
    """[(name, shape, init)] of every parameter and buffer of the model, in
    the program's state-dict names.  `init`: ("uniform", fan_in),
    ("xavier", fan_in + fan_out), "norm_weight", "norm_bias", "zeros",
    "ones", "bias_table"."""
    spec = []

    def linear(name, n_in, n_out, bias=True):
        spec.append((f"{name}.weight", (n_out, n_in), ("uniform", n_in)))
        if bias:
            spec.append((f"{name}.bias", (n_out,), ("uniform", n_in)))

    def norm(name, n):
        spec.append((f"{name}.weight", (n,), "norm_weight"))
        spec.append((f"{name}.bias", (n,), "norm_bias"))

    hidden = cfg["hidden_size"]
    if "audio" in modalities:
        pre = "extractors.audio.extractor"
        idx, c_in = 0, 1
        for block in CNN1D_BLOCKS:
            for feats, k, _, _ in block:
                spec.append((f"{pre}.conv{idx}.weight", (feats, c_in, k),
                             ("uniform", c_in * k)))
                spec.append((f"{pre}.conv{idx}.bias", (feats,),
                             ("uniform", c_in * k)))
                spec.append((f"{pre}.bn{idx}.weight", (feats,), "ones"))
                spec.append((f"{pre}.bn{idx}.bias", (feats,), "zeros"))
                spec.append((f"{pre}.bn{idx}.running_mean", (feats,), "zeros"))
                spec.append((f"{pre}.bn{idx}.running_var", (feats,), "ones"))
                idx, c_in = idx + 1, feats
        linear("extractors.audio.adaptor", 512, hidden)
    if "video" in modalities:
        pre = "extractors.video.backbone.backbone"
        e = cfg["swin_embed_dim"]
        kt, kh, kw = cfg["swin_patch"]
        spec.append((f"{pre}.patch_embed.weight", (e, 3, kt, kh, kw),
                     ("uniform", 3 * kt * kh * kw)))
        spec.append((f"{pre}.patch_embed.bias", (e,),
                     ("uniform", 3 * kt * kh * kw)))
        norm(f"{pre}.patch_norm", e)
        wt, wh, ww = cfg["swin_window"]
        table = (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1)
        stages = swin_stages(cfg)
        for s, (dim, heads, depth) in enumerate(stages):
            for i in range(depth):
                b = f"{pre}.stage{s}_block{i}"
                norm(f"{b}.norm1", dim)
                linear(f"{b}.attn.qkv", dim, 3 * dim)
                linear(f"{b}.attn.proj", dim, dim)
                spec.append((f"{b}.attn.relative_position_bias_table",
                             (table, heads), "bias_table"))
                norm(f"{b}.norm2", dim)
                linear(f"{b}.mlp_fc1", dim, cfg["swin_mlp_ratio"] * dim)
                linear(f"{b}.mlp_fc2", cfg["swin_mlp_ratio"] * dim, dim)
            if s < len(stages) - 1:
                norm(f"{pre}.merge{s}.norm", 4 * dim)
                linear(f"{pre}.merge{s}.reduction", 4 * dim, 2 * dim,
                       bias=False)
        norm(f"{pre}.norm", stages[-1][0])
    for i in range(cfg["fusion_layers"]):
        layer = f"fusion.encoder.layers.{i}"
        spec.append((f"{layer}.self_attn.in_proj_weight", (3 * hidden, hidden),
                     ("xavier", 4 * hidden)))
        spec.append((f"{layer}.self_attn.in_proj_bias", (3 * hidden,),
                     "zeros"))
        spec.append((f"{layer}.self_attn.out_proj.weight", (hidden, hidden),
                     ("uniform", hidden)))
        spec.append((f"{layer}.self_attn.out_proj.bias", (hidden,), "zeros"))
        linear(f"{layer}.linear1", hidden, cfg["fusion_ff"])
        linear(f"{layer}.linear2", cfg["fusion_ff"], hidden)
        norm(f"{layer}.norm1", hidden)
        norm(f"{layer}.norm2", hidden)
    norm("fusion.encoder.norm", hidden)
    adaptor = cfg["adaptor_out"]
    for m in sorted(modalities):
        linear(f"classifier.adaptor_{m}", hidden, adaptor)
    width = adaptor * len(modalities)
    for head in HEADS:
        linear(f"classifier.head_{head}_fc1", width, width // 3)
        linear(f"classifier.head_{head}_fc2", width // 3, 2)
    return spec


BUFFER_SUFFIXES = (".running_mean", ".running_var")


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


# ---------------------------------------------------------------- the draws
def mask_shapes(cfg, modalities, batch: int, video_trains: bool):
    """[(key, shape, rate)] of the step's random draws, in the order the
    model takes them: the audio tower's dropouts, the Swin blocks'
    stochastic depth (only when the tower trains), the fusion layer's
    attention, residual and feed-forward dropouts, the adaptors' dropouts
    in modality order, the heads' dropouts."""
    hidden = cfg["hidden_size"]
    tokens = feature_tokens(cfg, modalities)
    out = []
    if "audio" in modalities:
        c = [b[-1][0] for b in CNN1D_BLOCKS]
        for i, ch in enumerate(c):
            out.append((f"audio.drop{i}", (batch, 1, ch), 0.1))
        out.append(("audio.adaptor", (batch, tokens["audio"], hidden), 0.3))
    if "video" in modalities and video_trains:
        rows = batch * (cfg["video_frames"] // cfg["video_window"])
        for i, rate in enumerate(swin_block_rates(cfg)):
            if rate > 0:
                for j in (1, 2):
                    out.append((f"video.sd{i}.{j}", (rows, 1, 1, 1, 1), rate))
    t = sum(tokens.values())
    heads = cfg["fusion_heads"]
    for i in range(cfg["fusion_layers"]):
        out.append((f"fusion{i}.attn", (batch, heads, t, t), 0.1))
        out.append((f"fusion{i}.res1", (batch, t, hidden), 0.1))
        out.append((f"fusion{i}.ff", (batch, t, cfg["fusion_ff"]), 0.1))
        out.append((f"fusion{i}.res2", (batch, t, hidden), 0.1))
    for m in sorted(modalities):
        out.append((f"adaptor.{m}", (batch, tokens[m], cfg["adaptor_out"]),
                    0.3))
    width = cfg["adaptor_out"] * len(modalities)
    for head in HEADS:
        out.append((f"head.{head}", (batch, width // 3), 0.3))
    return out


def draw_masks(generator, cfg, modalities, batch: int, video_trains: bool,
               device):
    """{key: (uniforms, rate)}: one `torch.rand` per draw, from `generator`
    in the model's order."""
    return {key: (torch.rand(shape, generator=generator, device=device), rate)
            for key, shape, rate in mask_shapes(cfg, modalities, batch,
                                                video_trains)}


def feature_tokens(cfg, modalities):
    out = {}
    if "audio" in modalities:
        out["audio"] = audio_tokens(cfg["audio_samples"])
    if "text" in modalities:
        out["text"] = cfg["text_tokens"]
    if "video" in modalities:
        out["video"] = cfg["video_frames"] // cfg["video_window"]
    return out


# ---------------------------------------------------------------- towers
def audio_tower(x, p, masks, prod: Products):
    """(B, L) waveform -> (B, T, 768) tokens, train mode."""
    pre = "extractors.audio.extractor"
    h = prod.s(x)[:, None, :]  # (B, 1, L)
    idx = 0
    for block_i, block in enumerate(CNN1D_BLOCKS):
        for _, _, stride, pad in block:
            h = prod.conv1d(h, p[f"{pre}.conv{idx}.weight"],
                            p[f"{pre}.conv{idx}.bias"], stride, pad)
            mean = h.mean(dim=(0, 2), keepdim=True)
            var = (h - mean).square().mean(dim=(0, 2), keepdim=True)
            h = prod.s((h - mean) * torch.rsqrt(var + 1e-5)
                       * p[f"{pre}.bn{idx}.weight"][:, None]
                       + p[f"{pre}.bn{idx}.bias"][:, None])
            h = torch.relu(h)
            idx += 1
        if block_i < len(CNN1D_BLOCKS) - 1:
            h = F.max_pool1d(h, 4)
        u, rate = masks[f"audio.drop{block_i}"]
        h = prod.dropout(h, u.transpose(1, 2), rate)  # (B, C, 1): channels
    h = h.transpose(1, 2)  # (B, T, 512)
    h = torch.relu(prod.linear(h, p["extractors.audio.adaptor.weight"],
                               p["extractors.audio.adaptor.bias"]))
    return prod.dropout(h, *masks["audio.adaptor"])


def relative_position_index(window):
    wt, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh),
                                  np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array([wt - 1, wh - 1, ww - 1])
    return (rel[..., 0] * (2 * wh - 1) * (2 * ww - 1)
            + rel[..., 1] * (2 * ww - 1) + rel[..., 2])


def shifted_window_mask(grid, window, shift):
    """(nW, N, N): -100 between tokens from different regions of the rolled
    grid, 0 within one (torchvision's mask)."""
    region = np.zeros(grid, np.int64)
    cnt = 0
    bounds = [((0, g - w), (g - w, g - s), (g - s, g))
              for g, w, s in zip(grid, window, shift)]
    for a in bounds[0]:
        for b in bounds[1]:
            for c in bounds[2]:
                region[a[0]:a[1], b[0]:b[1], c[0]:c[1]] = cnt
                cnt += 1
    (pt, ph, pw), (wt, wh, ww) = grid, window
    region = region.reshape(pt // wt, wt, ph // wh, wh, pw // ww, ww)
    region = region.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wt * wh * ww)
    return np.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)


def window_attention(x, p, name, heads, full_window, shift_on, prod):
    """One (shifted-)window attention of a (B, T, H, W, C) grid."""
    b, t, h, w, c = x.shape
    window, shift = list(full_window), [s // 2 for s in full_window]
    if not shift_on:
        shift = [0, 0, 0]
    for i, size in enumerate((t, h, w)):
        if size <= window[i]:
            window[i], shift[i] = size, 0
    wt, wh, ww = window
    x = F.pad(x, (0, 0, 0, -w % ww, 0, -h % wh, 0, -t % wt))
    pt, ph, pw = x.shape[1:4]
    if any(shift):
        x = torch.roll(x, [-s for s in shift], dims=(1, 2, 3))
    win = x.reshape(b, pt // wt, wt, ph // wh, wh, pw // ww, ww, c)
    win = win.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)
    n = win.shape[1]
    d = c // heads
    qkv = prod.linear(win, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"])
    q, k, v = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = prod.scores(q * d ** -0.5, k)
    index = torch.as_tensor(
        relative_position_index(full_window)[:n, :n].reshape(-1),
        device=x.device)
    bias = p[f"{name}.relative_position_bias_table"][index]
    scores = scores + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
    if any(shift):
        mask = torch.as_tensor(shifted_window_mask((pt, ph, pw), window, shift),
                               dtype=scores.dtype, device=x.device)
        nw = mask.shape[0]
        scores = (scores.reshape(-1, nw, heads, n, n)
                  + mask[None, :, None]).reshape(-1, heads, n, n)
    # under a compute dtype the window kernels keep the probabilities f32
    # exact in P.V (two bf16 pieces), so only V is a stored operand
    probs = torch.softmax(scores, dim=-1)
    out = prod.s((probs if prod.mode in STORED else prod.r(probs))
                 @ prod.r(v))
    out = out.transpose(1, 2).reshape(-1, n, c)
    out = prod.linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])
    out = out.reshape(b, pt // wt, ph // wh, pw // ww, wt, wh, ww, c)
    out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, pt, ph, pw, c)
    if any(shift):
        out = torch.roll(out, shift, dims=(1, 2, 3))
    return out[:, :t, :h, :w]


def swin_tower(x, p, cfg, sd_masks, prod: Products):
    """(B', window, H, W, 3) clips -> (B', 768).  `sd_masks`: {block index:
    ((uniforms of sd1, sd2), rate)} for this block of rows, or None (eval:
    no stochastic depth)."""
    pre = "extractors.video.backbone.backbone"
    h = prod.conv3d(prod.s(x).permute(0, 4, 1, 2, 3),
                    p[f"{pre}.patch_embed.weight"],
                    p[f"{pre}.patch_embed.bias"], tuple(cfg["swin_patch"]))
    h = prod.layer_norm(h.permute(0, 2, 3, 4, 1), p, f"{pre}.patch_norm")
    stages = swin_stages(cfg)
    block = 0
    for s, (dim, heads, depth) in enumerate(stages):
        for i in range(depth):
            b = f"{pre}.stage{s}_block{i}"
            branch = window_attention(prod.layer_norm(h, p, f"{b}.norm1"), p,
                                      f"{b}.attn", heads,
                                      tuple(cfg["swin_window"]), i % 2 == 1,
                                      prod)
            if sd_masks is not None and block in sd_masks:
                (u1, _), rate = sd_masks[block]
                branch = prod.dropout(branch, u1, rate)
            h = prod.s(h + branch)
            mlp = prod.linear(prod.layer_norm(h, p, f"{b}.norm2"),
                              p[f"{b}.mlp_fc1.weight"], p[f"{b}.mlp_fc1.bias"])
            mlp = prod.linear(prod.s(F.gelu(mlp)), p[f"{b}.mlp_fc2.weight"],
                              p[f"{b}.mlp_fc2.bias"])
            if sd_masks is not None and block in sd_masks:
                (_, u2), rate = sd_masks[block]
                mlp = prod.dropout(mlp, u2, rate)
            h = prod.s(h + mlp)
            block += 1
        if s < len(stages) - 1:
            hh, ww = h.shape[2:4]
            h = F.pad(h, (0, 0, 0, ww % 2, 0, hh % 2))
            h = torch.cat([h[:, :, 0::2, 0::2], h[:, :, 1::2, 0::2],
                           h[:, :, 0::2, 1::2], h[:, :, 1::2, 1::2]], dim=-1)
            h = prod.linear(prod.layer_norm(h, p, f"{pre}.merge{s}.norm"),
                            p[f"{pre}.merge{s}.reduction.weight"])
    return prod.s(prod.layer_norm(h, p, f"{pre}.norm").mean(dim=(1, 2, 3)))


def swin_sd_masks(masks, cfg, rows: slice):
    """The stochastic-depth draws of `rows` of the folded windows, by block;
    None when the tower does not train (no draws)."""
    out = {}
    for i, rate in enumerate(swin_block_rates(cfg)):
        key = f"video.sd{i}.1"
        if key in masks:
            out[i] = ((masks[key][0][rows], masks[f"video.sd{i}.2"][0][rows]),
                      rate)
    return out or None


def fusion_encoder(x, p, cfg, masks, prod: Products):
    """Post-LN encoder over (B, T, 768) with zero rows masked as keys."""
    pad = x.sum(dim=2) == 0  # (B, T) True: masked key
    b, t, e = x.shape
    heads = cfg["fusion_heads"]
    d = e // heads
    for i in range(cfg["fusion_layers"]):
        layer = f"fusion.encoder.layers.{i}"
        qkv = prod.linear(x, p[f"{layer}.self_attn.in_proj_weight"],
                          p[f"{layer}.self_attn.in_proj_bias"])
        q, k, v = qkv.view(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        scores = prod.scores(q, k) / math.sqrt(d)
        scores = scores.masked_fill(pad[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        attn = torch.where((~pad).any(dim=-1)[:, None, None, None], attn,
                           torch.zeros_like(attn))
        attn = prod.dropout(attn, *masks[f"fusion{i}.attn"])
        out = prod.matmul(attn, v).transpose(1, 2).reshape(b, t, e)
        out = prod.linear(out, p[f"{layer}.self_attn.out_proj.weight"],
                          p[f"{layer}.self_attn.out_proj.bias"])
        x = prod.layer_norm(
            prod.s(x + prod.dropout(out, *masks[f"fusion{i}.res1"])), p,
            f"{layer}.norm1")
        ff = torch.relu(prod.linear(x, p[f"{layer}.linear1.weight"],
                                    p[f"{layer}.linear1.bias"]))
        ff = prod.linear(prod.dropout(ff, *masks[f"fusion{i}.ff"]),
                         p[f"{layer}.linear2.weight"],
                         p[f"{layer}.linear2.bias"])
        x = prod.layer_norm(
            prod.s(x + prod.dropout(ff, *masks[f"fusion{i}.res2"])), p,
            f"{layer}.norm2")
    return prod.layer_norm(x, p, "fusion.encoder.norm")


def heads_logits(feats: Dict[str, torch.Tensor], p, cfg, masks,
                 prod: Products):
    """{modality: (B, T, 768)} -> fused -> {head: (B, 2) logits}."""
    names = sorted(feats)
    bounds, offset = {}, 0
    for m in names:
        bounds[m] = (offset, offset + feats[m].shape[1])
        offset += feats[m].shape[1]
    fused = fusion_encoder(torch.cat([feats[m] for m in names], dim=1), p,
                           cfg, masks, prod)
    adapted = []
    for m in names:
        a = prod.linear(fused[:, bounds[m][0]:bounds[m][1]],
                        p[f"classifier.adaptor_{m}.weight"],
                        p[f"classifier.adaptor_{m}.bias"])
        adapted.append(prod.s(torch.relu(
            prod.dropout(a, *masks[f"adaptor.{m}"])).mean(dim=1)))
    x = torch.cat(adapted, dim=1)
    out = {}
    for head in HEADS:
        h = torch.relu(prod.linear(x, p[f"classifier.head_{head}_fc1.weight"],
                                   p[f"classifier.head_{head}_fc1.bias"]))
        out[head] = prod.linear(prod.dropout(h, *masks[f"head.{head}"]),
                                p[f"classifier.head_{head}_fc2.weight"],
                                p[f"classifier.head_{head}_fc2.bias"])
    return out


def head_loss(kind, logits, labels, mask, alpha=None, gamma=2.0):
    """The masked mean of the head's per-row loss."""
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[:, None])[:, 0]
    if kind == "focal":
        ce = -logp * torch.as_tensor(alpha, dtype=logp.dtype,
                                     device=logp.device)[labels.long()]
        per_row = (1.0 - logp.exp()) ** gamma * ce
    else:
        per_row = -logp
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)


def total_loss(logits, batch, alpha, gamma):
    """The heads' losses summed over the heads the batch labels (a batch
    carries a head's labels only where some row has one)."""
    total = 0.0
    for head, kind in (("phys", "focal"), ("verb", "ce")):
        if head in batch["labels"]:
            total = total + head_loss(kind, logits[head],
                                      batch["labels"][head],
                                      batch["label_mask"][head], alpha, gamma)
    return total
