"""Windowed frozen video feature extraction (the JAX package's
models/video_extractors.py).

A clip's frame windows are folded into the batch axis, so the backbone runs
ONCE on (B * T/window, window, H, W, C) instead of once per window.
"""

import torch
from torch import nn

from ..ops.video import unwindow_features, window_frames


class WindowedVideoExtractor(nn.Module):
    """(B, T, H, W, C) -> (B, T//window, D) token sequence.

    `backbone` maps (B', window, H, W, C) -> (B', D) and is frozen (no
    gradient), as the reference's extractors were.  An unfrozen backbone
    (`freeze=False`) arrives with Swin fine-tuning and raises until then."""

    def __init__(self, backbone: nn.Module, window: int = 16,
                 freeze: bool = True):
        super().__init__()
        if not freeze:
            raise NotImplementedError(
                "an unfrozen video backbone (video_freeze=False) is not "
                "ported yet: it arrives with Swin fine-tuning")
        self.backbone = backbone
        self.window = window

    def forward(self, x):
        wins, num = window_frames(x, self.window)
        with torch.no_grad():
            feats = self.backbone(wins)
        return unwindow_features(feats, x.shape[0], num)
