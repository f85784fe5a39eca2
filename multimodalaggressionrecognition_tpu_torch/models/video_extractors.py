"""Windowed video feature extraction (the JAX package's
models/video_extractors.py).

A clip's frame windows are folded into the batch axis, so the backbone runs
ONCE on (B * T/window, window, H, W, C) instead of once per window.
"""

import torch
from torch import nn

from ..ops.video import unwindow_features, window_frames
from .stochastic import checkpoint


class WindowedVideoExtractor(nn.Module):
    """(B, T, H, W, C) -> (B, T//window, D) token sequence.

    `backbone` maps (B', window, H, W, C) -> (B', D).  Frozen (the default,
    as the reference's extractors were), it has no trainable parameters,
    runs without gradient and stays in eval mode even when the model trains.
    Unfrozen (`freeze=False`) it trains; `remat` then checkpoints the whole
    backbone call, recomputing its activations in the backward."""

    def __init__(self, backbone: nn.Module, window: int = 16,
                 freeze: bool = True, remat: bool = False):
        super().__init__()
        self.backbone = backbone
        self.window = window
        self.freeze = freeze
        self.remat = remat
        if freeze:
            backbone.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze:
            self.backbone.eval()
        return self

    def forward(self, x):
        wins, num = window_frames(x, self.window)
        if self.freeze:
            with torch.no_grad():
                feats = self.backbone(wins)
        elif self.remat and self.training and torch.is_grad_enabled():
            feats = checkpoint(self.backbone, wins)
        else:
            feats = self.backbone(wins)
        return unwindow_features(feats, x.shape[0], num)
