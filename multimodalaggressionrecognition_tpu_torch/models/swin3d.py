"""Swin3D video transformer (tiny config), channels-last (the JAX package's
models/swin3d.py, which follows torchvision's swin3d_t).

Patch embed Conv3d(3->96, (2,4,4)), stages of shifted-window attention
blocks (window (8,7,7), shift (4,3,3), depths (2,2,6,2), heads
(3,6,12,24)), patch merging between stages, final LayerNorm; the extractor
mean-pools the (T', H', W') grid to a 768-d vector.  Every block's window
attention runs through the fused window-attention kernels, forward and
backward (ops/cuda/window_attention.py `window_attention`).  Semantics
carried over exactly:

- a window axis is clamped to the input size when the input is no larger
  than the window, and that axis is then not shifted;
- the input is padded to window multiples and rolled by -shift; the
  shifted-window mask (0 / -100) is built on the padded sizes;
- the bias table and position index are those of the FULL window, the
  index sliced to the clamped window's (n, n) block (checkpoint parity);
- windows are ordered (b, t/wt, h/wh, w/ww), which the kernel's
  `w % nW_img` mask lookup relies on.

Train mode: row-wise stochastic depth (`x / keep`, per-block rates rising
linearly to 0.2) drawn from an explicit generator (models/stochastic.py),
and optional per-block gradient checkpointing (`remat`, the JAX package's
`nn.remat` of each SwinBlock3d with the save-nothing policy).  The "dots"
policy (save the matmul outputs) is not ported.
"""

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.window_attention import window_attention
from ..ops.erf import check_gelu_mode, gelu
from .nn3d import Conv3d
from .stochastic import Stochastic, checkpoint


@functools.lru_cache(maxsize=8)
def _relative_position_index(window: Tuple[int, int, int]) -> np.ndarray:
    wt, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh), np.arange(ww),
                                  indexing="ij"))  # (3, wt, wh, ww)
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (3, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[..., 0] += wt - 1
    rel[..., 1] += wh - 1
    rel[..., 2] += ww - 1
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= (2 * ww - 1)
    return rel.sum(-1)  # (N, N)


@functools.lru_cache(maxsize=32)
def _attention_mask(pt: int, ph: int, pw: int,
                    window: Tuple[int, int, int],
                    shift: Tuple[int, int, int]) -> np.ndarray | None:
    """(nW, N, N) additive mask (0 / -100) for shifted windows, or None."""
    if not any(shift):
        return None
    wt, wh, ww = window
    region = np.zeros((pt, ph, pw), np.int32)
    cnt = 0
    for t_slice in ((0, pt - wt), (pt - wt, pt - shift[0]), (pt - shift[0], pt)):
        for h_slice in ((0, ph - wh), (ph - wh, ph - shift[1]), (ph - shift[1], ph)):
            for w_slice in ((0, pw - ww), (pw - ww, pw - shift[2]), (pw - shift[2], pw)):
                region[t_slice[0]:t_slice[1], h_slice[0]:h_slice[1],
                       w_slice[0]:w_slice[1]] = cnt
                cnt += 1
    region = region.reshape(pt // wt, wt, ph // wh, wh, pw // ww, ww)
    region = region.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wt * wh * ww)
    diff = region[:, :, None] - region[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x, window):
    b, t, h, w, c = x.shape
    wt, wh, ww = window
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * (t // wt) * (h // wh) * (w // ww), wt * wh * ww, c)


def _window_reverse(windows, window, b, t, h, w):
    wt, wh, ww = window
    c = windows.shape[-1]
    x = windows.reshape(b, t // wt, h // wh, w // ww, wt, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t, h, w, c)


class ShiftedWindowAttention3d(nn.Module):
    """(B, T, H, W, C) -> same shape: (shifted-)window multi-head attention
    with a learned relative-position bias."""

    def __init__(self, dim: int, num_heads: int,
                 window: Tuple[int, int, int] = (8, 7, 7),
                 shift: Tuple[int, int, int] = (0, 0, 0)):
        super().__init__()
        self.num_heads = num_heads
        self.window, self.shift = tuple(window), tuple(shift)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        fwt, fwh, fww = self.window
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * fwt - 1) * (2 * fwh - 1) * (2 * fww - 1), num_heads))
        self._consts = {}  # device-resident index and masks, by key

    def _const(self, key, device, make):
        key = key + (str(device),)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = make().to(device)
        return t

    def forward(self, x):
        b, t, h, w, c = x.shape
        window, shift = list(self.window), list(self.shift)
        for i, size in enumerate((t, h, w)):
            if size <= window[i]:
                window[i] = size
                shift[i] = 0
        window, shift = tuple(window), tuple(shift)
        wt, wh, ww = window
        pad_t, pad_h, pad_w = (-t % wt, -h % wh, -w % ww)
        xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_t))
        pt, ph, pw = t + pad_t, h + pad_h, w + pad_w
        if any(shift):
            xp = torch.roll(xp, (-shift[0], -shift[1], -shift[2]), (1, 2, 3))

        windows = _window_partition(xp, window)  # (B*nW, N, C)
        n = windows.shape[1]
        heads = self.num_heads
        qkv = self.qkv(windows)

        # the FULL window's index, sliced to the (possibly clamped) window
        index = self._const(("index", n), x.device, lambda: torch.from_numpy(
            _relative_position_index(self.window)[:n, :n].reshape(-1).copy()))
        bias = self.relative_position_bias_table[index].reshape(n, n, heads)
        bias = bias.permute(2, 0, 1).contiguous()  # (heads, N, N)
        mask = None
        if any(shift):
            mask = self._const(("mask", pt, ph, pw, window, shift), x.device,
                               lambda: torch.from_numpy(_attention_mask(
                                   pt, ph, pw, window, shift)))
        out = self.proj(window_attention(qkv, bias, mask, heads))

        xp = _window_reverse(out, window, b, pt, ph, pw)
        if any(shift):
            xp = torch.roll(xp, shift, (1, 2, 3))
        return xp[:, :t, :h, :w]


class StochasticDepth(Stochastic):
    """Row-wise stochastic depth (torchvision's 'row' mode): drops a whole
    sample's residual branch; the identity in eval mode."""

    def noise_shape(self, x):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class SwinBlock3d(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 window: Tuple[int, int, int] = (8, 7, 7),
                 shift: Tuple[int, int, int] = (0, 0, 0),
                 mlp_ratio: float = 4.0, sd_prob: float = 0.0,
                 gelu: str = "poly"):
        super().__init__()
        self.gelu = check_gelu_mode(gelu)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention3d(dim, num_heads, window, shift)
        self.sd1 = StochasticDepth(sd_prob)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.sd2 = StochasticDepth(sd_prob)

    def forward(self, x):
        x = x + self.sd1(self.attn(self.norm1(x)))
        h = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x)), self.gelu))
        return x + self.sd2(h)


def _check_remat_policy(policy):
    if policy == "dots":  # save the matmul outputs
        raise NotImplementedError(
            "remat_policy 'dots' is not ported (it never won in the JAX "
            "package's sweep); use 'none'")
    if policy not in ("none", None):
        raise ValueError(f"remat_policy must be 'none' (or None), got "
                         f"{policy!r} — a typo here would silently run the "
                         "save-nothing policy")
    return policy


class PatchMerging3d(nn.Module):
    """Spatial 2x2 merge: concat(x00, x10, x01, x11) -> LN -> Linear(4C, 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[2:4]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer3d(nn.Module):
    """Patch embed + stages + final norm: (B, T, H, W, 3) ->
    (B, T', H', W', C_final)."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: Tuple[int, int, int] = (8, 7, 7),
                 stochastic_depth_prob: float = 0.2, gelu: str = "poly",
                 in_channels: int = 3, remat: bool = False,
                 remat_policy="none"):
        super().__init__()
        # per-block gradient checkpointing: each block keeps only its input
        # and recomputes its inside in the backward
        self.remat = remat
        _check_remat_policy(remat_policy)
        self.patch_embed = Conv3d(in_channels, embed_dim, (2, 4, 4),
                                  stride=(2, 4, 4))
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.stages = []  # (block names, merge name or None) per stage
        total = sum(depths)
        block_id, dim = 0, embed_dim
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            names = []
            for i in range(depth):
                shift = tuple(0 if i % 2 == 0 else size // 2 for size in window)
                sd = stochastic_depth_prob * block_id / max(total - 1, 1)
                names.append(f"stage{stage}_block{i}")
                self.add_module(names[-1], SwinBlock3d(
                    dim, heads, window, shift, sd_prob=sd, gelu=gelu))
                block_id += 1
            merge = None
            if stage < len(depths) - 1:
                merge = f"merge{stage}"
                self.add_module(merge, PatchMerging3d(dim))
                dim *= 2
            self.stages.append((names, merge))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.out_dim = dim

    def forward(self, x):
        h = self.patch_norm(self.patch_embed(x))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for names, merge in self.stages:
            for name in names:
                block = getattr(self, name)
                h = checkpoint(block, h) if remat else block(h)
            if merge is not None:
                h = getattr(self, merge)(h)
        return self.norm(h)


class Swin3dTExtractor(nn.Module):
    """Headless swin3d_t: (B, T, H, W, 3) -> (B, 768) mean-pooled features."""

    def __init__(self, gelu: str = "poly", remat: bool = False,
                 remat_policy="none"):
        super().__init__()
        self.backbone = SwinTransformer3d(gelu=gelu, remat=remat,
                                          remat_policy=remat_policy)

    def forward(self, x):
        return self.backbone(x).mean(dim=(1, 2, 3))
