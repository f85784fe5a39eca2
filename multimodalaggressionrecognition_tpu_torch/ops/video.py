"""Folding a clip's frame windows into the batch (the JAX package's
ops/video.py `window_frames` / `unwindow_features`), so a frozen video
backbone runs once over every window of every clip.

Resize, normalize and box rasterization are not ported yet: the served
tri-modal path takes frames already at the model's size.
"""


def window_frames(x, window: int):
    """(B, T, H, W, C) -> ((B * T//window, window, H, W, C), T//window).
    Trailing frames that do not fill a window are dropped."""
    b, t = x.shape[:2]
    num = t // window
    return x[:, :num * window].reshape(b * num, window, *x.shape[2:]), num


def unwindow_features(feats, batch: int, num_windows: int):
    """(B * num, D) -> (B, num, D)."""
    return feats.reshape(batch, num_windows, -1)
