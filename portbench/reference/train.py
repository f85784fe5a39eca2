"""The reference's training steps: the plain model of `model.py` trained
with a plain Adam (optax's: betas 0.9, 0.999, eps 1e-8 outside the square
root, bias-corrected), from the benchmark's weights, batches and draws.

The video tower runs in blocks of clips so that a full-size batch fits
beside nothing else on the card: its features are computed without a
gradient, the rest of the model is differentiated whole (BatchNorm's batch
statistics need every row at once), and each block of clips is then run
again with a gradient and back-propagated from its rows of the features'
gradient.  The sum over blocks is the whole batch's gradient.
"""

from typing import Dict, Optional

import torch

from . import model as M


class ReferenceTrainer:
    """Trainable parameters `params` ({name: tensor}, float32, on the
    device), Adam's moments, and the step function."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg, modalities,
                 video_trains: bool, lr: float = 1e-3,
                 products: Optional[str] = None, clip_block: int = 4):
        self.cfg, self.modalities = cfg, tuple(sorted(modalities))
        self.video_trains = video_trains and "video" in modalities
        self.prod = M.Products(products)
        self.clip_block = clip_block
        self.lr = lr
        self.params = {n: w.detach().clone().float()
                       for n, w in weights.items() if not M.is_buffer(n)}
        self.trainable = [n for n in self.params if self.video_trains
                          or not n.startswith("extractors.video.")]
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.t = 0

    # ------------------------------------------------------------ forward
    def _video_feats(self, video, masks):
        """(B, frames, H, W, 3) -> (B, frames / window, 768), blocks of
        `clip_block` clips at a time, without a gradient."""
        cfg = self.cfg
        win = cfg["video_window"]
        b, t = video.shape[:2]
        num = t // win
        out = []
        with torch.no_grad():
            for c0 in range(0, b, self.clip_block):
                c1 = min(b, c0 + self.clip_block)
                clips = video[c0:c1, :num * win].reshape(
                    (c1 - c0) * num, win, *video.shape[2:])
                rows = slice(c0 * num, c1 * num)
                sd = (M.swin_sd_masks(masks, cfg, rows) if self.video_trains
                      else None)
                out.append(M.swin_tower(clips, self.params, cfg, sd,
                                        self.prod).reshape(c1 - c0, num, -1))
        return torch.cat(out)

    def _video_backward(self, video, masks, grad):
        """Accumulate the Swin parameters' gradient from d loss / d
        features `grad` (B, frames / window, 768), block by block."""
        cfg = self.cfg
        win = cfg["video_window"]
        b, t = video.shape[:2]
        num = t // win
        names = [n for n in self.trainable if n.startswith("extractors.video.")]
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in names}
        p = dict(self.params)
        p.update(leaves)
        total = {n: torch.zeros_like(self.params[n]) for n in names}
        for c0 in range(0, b, self.clip_block):
            c1 = min(b, c0 + self.clip_block)
            clips = video[c0:c1, :num * win].reshape(
                (c1 - c0) * num, win, *video.shape[2:])
            sd = M.swin_sd_masks(masks, cfg, slice(c0 * num, c1 * num))
            feats = M.swin_tower(clips, p, cfg, sd, self.prod)
            grads = torch.autograd.grad(
                feats, [leaves[n] for n in names],
                grad.reshape(-1, grad.shape[-1])[c0 * num:c1 * num])
            for n, g in zip(names, grads):
                total[n] += g
        return total

    def loss_and_grads(self, batch, masks, whole: bool = False):
        """(loss, {name: gradient}) of one batch: the model's forward and
        backward in train mode.  `whole` runs the video tower on every
        clip at once, inside the one backward (on the meta device, to count
        operations)."""
        mods = batch["modalities"]
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in self.trainable}
        p = dict(self.params)
        feats = {}
        video_leaf = None
        if "video" in self.modalities:
            video = mods["video"]["data"]
            if whole:
                win = self.cfg["video_window"]
                b, t = video.shape[:2]
                num = t // win
                clips = video[:, :num * win].reshape(b * num, win,
                                                     *video.shape[2:])
                sd = (M.swin_sd_masks(masks, self.cfg, slice(None))
                      if self.video_trains else None)
                vp = dict(p)
                vp.update({n: leaves[n] for n in leaves
                           if n.startswith("extractors.video.")})
                if self.video_trains:
                    feats["video"] = M.swin_tower(clips, vp, self.cfg, sd,
                                                  self.prod).reshape(b, num, -1)
                else:
                    with torch.no_grad():
                        feats["video"] = M.swin_tower(
                            clips, p, self.cfg, None,
                            self.prod).reshape(b, num, -1)
            else:
                video_leaf = self._video_feats(video, masks)
                video_leaf.requires_grad_(self.video_trains)
                feats["video"] = video_leaf
        p.update({n: leaves[n] for n in leaves
                  if not n.startswith("extractors.video.") or whole})
        if "audio" in self.modalities:
            feats["audio"] = M.audio_tower(mods["audio"]["data"], p, masks,
                                           self.prod)
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
               if whole or not n.startswith("extractors.video.")]
        targets = [leaves[n] for n in wrt]
        if video_leaf is not None and self.video_trains:
            targets.append(video_leaf)
        grads = torch.autograd.grad(loss, targets, allow_unused=True)
        out = {n: (torch.zeros_like(self.params[n]) if g is None else g)
               for n, g in zip(wrt, grads)}
        if video_leaf is not None and self.video_trains:
            out.update(self._video_backward(mods["video"]["data"], masks,
                                            grads[-1]))
        return loss.detach(), out

    # ------------------------------------------------------------ update
    @torch.no_grad()
    def adam(self, grads):
        """optax.adam at the constant rate."""
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n in self.trainable:
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            self.params[n] -= self.lr * m_hat / (v_hat.sqrt() + eps)

    def step(self, batch, masks):
        """One training step; returns (loss, gradients)."""
        loss, grads = self.loss_and_grads(batch, masks)
        self.adam(grads)
        return loss, grads

