"""Video preprocessing (the JAX package's ops/video.py): a bilinear resize
as two matmuls, and folding a clip's frame windows into the batch
(`window_frames` / `unwindow_features`), so a frozen video backbone runs
once over every window of every clip.

`resize_bilinear` is `W_h @ image @ W_w^T` for precomputed interpolation
matrices: `resize_matrix(..., antialias=True)` matches torch's
F.interpolate(mode='bilinear', antialias=True) (torchvision's Resize, the
reference's transform), `antialias=False` the plain bilinear one.  The
JAX package leaves this to XLA, outside any Pallas kernel, so here it is
two einsums.  `normalize` is the (x - mean) / std channel transform, and
`rasterize_boxes` fills per-frame XYXY boxes into {0, 1} masks by one
comparison, as the reference's cv2.rectangle loop did.  The JAX package's
adaptive pool matrices are `F.adaptive_avg_pool2d` where the port needs
them (models/vgg.py).
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_matrix_np(in_size: int, out_size: int,
                      antialias: bool = True) -> np.ndarray:
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), np.float64)
    if antialias and scale > 1.0:
        support = scale  # bilinear filter support (1.0) * scale
        for i in range(out_size):
            center = (i + 0.5) * scale
            lo = max(int(center - support + 0.5), 0)
            hi = min(int(center + support + 0.5), in_size)
            j = np.arange(lo, hi, dtype=np.float64)
            w = np.clip(1.0 - np.abs((j + 0.5 - center) / scale), 0.0, None)
            s = w.sum()
            if s > 0:
                mat[i, lo:hi] = w / s
    else:
        for i in range(out_size):
            center = np.clip((i + 0.5) * scale - 0.5, 0.0, in_size - 1)
            lo = int(np.floor(center))
            hi = min(lo + 1, in_size - 1)
            frac = center - lo
            mat[i, lo] += 1.0 - frac
            mat[i, hi] += frac
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(in_size: int, out_size: int, antialias: bool,
                      device: torch.device) -> torch.Tensor:
    # built once per device: a copy from pageable host memory synchronises
    # the stream, which a per-forward build would pay twice each step.
    # Outside inference mode, so a later autograd pass may use it too
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix_np(in_size, out_size,
                                                  antialias)).to(device)


def resize_matrix(in_size: int, out_size: int, antialias: bool = True,
                  device="cpu") -> torch.Tensor:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix,
    cached on `device` (shared: do not write into it).

    antialias=True: the triangle filter's support scales with a downscale
    ratio, and its window is truncated at the borders and renormalized (no
    edge replication).  antialias=False (and every upscale): two taps
    around (i + 0.5) * scale - 0.5, clamped at the borders
    (align_corners=False)."""
    return _resize_matrix_on(in_size, out_size, antialias,
                             torch.device(device))


def resize_bilinear(x, out_h: int, out_w: int, antialias: bool = True):
    """Resize (..., H, W, C) images via two matmuls, contracting H, then
    W; f32 whatever x's dtype, as the JAX op's f32 products return (a
    bf16 clip widens exactly)."""
    h, w = x.shape[-3], x.shape[-2]
    wh = resize_matrix(h, out_h, antialias, x.device)
    ww = resize_matrix(w, out_w, antialias, x.device)
    y = torch.einsum("...hwc,oh->...owc", x.float(), wh)
    return torch.einsum("...hwc,ow->...hoc", y, ww)


def normalize(x, mean, std):
    """Channel-last normalization: (x - mean) / std."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def rasterize_boxes(boxes, height: int, width: int):
    """XYXY boxes (..., T, 4) -> filled masks (..., T, H, W) in {0, 1}
    (f32): both corners inclusive, a fractional corner widened outward
    (floor of the start, ceil of the end), as cv2.rectangle(thickness=-1)
    fills."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    ys = torch.arange(height, dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(width, dtype=boxes.dtype, device=boxes.device)
    row = (ys >= torch.floor(y1)[..., None]) & (ys <= torch.ceil(y2)[..., None])
    col = (xs >= torch.floor(x1)[..., None]) & (xs <= torch.ceil(x2)[..., None])
    return (row[..., :, None] & col[..., None, :]).float()


def window_frames(x, window: int):
    """(B, T, H, W, C) -> ((B * T//window, window, H, W, C), T//window).
    Trailing frames that do not fill a window are dropped."""
    b, t = x.shape[:2]
    num = t // window
    return x[:, :num * window].reshape(b * num, window, *x.shape[2:]), num


def unwindow_features(feats, batch: int, num_windows: int):
    """(B * num, D) -> (B, num, D)."""
    return feats.reshape(batch, num_windows, -1)
