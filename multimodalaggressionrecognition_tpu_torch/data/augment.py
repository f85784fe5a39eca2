"""Paired video + bounding-box augmentations on the host, in numpy (the JAX
package's data/augment.py, without OpenCV).

The reference's paired transforms (reference datasets.py:22-133,
instantiated at reference train3dcnn.py:70-75) with torchvision v2's
parameter sampling and matrix math: one random parameter draw per *clip*,
applied identically to every frame and to the per-frame XYXY boxes:
perspective, affine (rotate / translate / scale / shear), horizontal flip,
in the reference's order.  The draws consume a numpy `Generator` exactly
as the JAX package's do, so one seed gives the same parameters and the
same boxes.

torchvision v2 semantics:

- ``RandomAffine._get_params``: angle ~ U(-degrees, degrees); translation
  ``int(round(U(-t*size, t*size)))`` per axis; scale ~ U(lo, hi); shear
  ``(U(sx0, sx1), U(sy0, sy1))`` in degrees.
- forward point map ``p' = scale * RSS(angle, shear) @ (p - c) + c + t``
  with ``c = (0.5*w, 0.5*h)`` (``_get_inverse_affine_matrix`` with
  ``inverted=False``).
- ``RandomPerspective._get_params``: the 4 output corners are displaced
  *inward* by integer ``randint(0, int(d * half) + 1)`` amounts from the
  ``(w-1, h-1)``-convention corners.
- boxes: the 4 corners through the forward matrix, re-axis-aligned
  (min/max), then clamped into the canvas (x in [0, w], y in [0, h]).
- horizontal flip on boxes is ``x' = w - x`` (continuous edge
  coordinates, no ``-1``).

The frames are warped by inverse mapping with zero fill, as OpenCV's
warpAffine / warpPerspective (which the JAX package calls) compute them on
float frames: pixel centres at integer coordinates, so the image-space
centre is the continuous one shifted by half a pixel (``c - 0.5``); the
forward matrix is inverted and every source position computed in float64;
affine takes the nearest pixel (rounded half to even), perspective the
bilinear blend of four taps with float32 weights.  The homography is the
solve of the 8-coefficient system.
"""

import math
from typing import Tuple

import numpy as np


def _clamp_boxes(boxes, width, height):
    """torchvision clamp_bounding_boxes: XYXY into [0, w] x [0, h]."""
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, width)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, height)
    return out


def hflip_video_boxes(video, boxes, rng, p: float = 0.5):
    """video (T, H, W, C), boxes (T, 4) XYXY or None."""
    if rng.random() >= p:
        return video, boxes
    w = video.shape[2]
    video = video[:, :, ::-1].copy()
    if boxes is not None:
        flipped = np.stack([w - boxes[:, 2], boxes[:, 1], w - boxes[:, 0],
                            boxes[:, 3]], axis=1)
        # the reference transforms only non-empty boxes (datasets.py:74-84):
        # empty rows stay all-zero
        keep = boxes.sum(axis=1) > 0
        boxes = np.where(keep[:, None], flipped, boxes)
    return video, boxes


def _apply_matrix_to_boxes(boxes, mat, width, height, perspective=False):
    """Transform XYXY boxes by a 2x3 / 3x3 forward matrix; re-axis-align
    (corner min/max) and clamp into the canvas."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], 1), np.stack([x2, y1], 1),
        np.stack([x1, y2], 1), np.stack([x2, y2], 1)], axis=1)  # (T, 4, 2)
    ones = np.ones((*corners.shape[:2], 1), np.float64)
    pts = np.concatenate([corners.astype(np.float64), ones], axis=-1)
    out = pts @ mat.T
    if perspective:
        out = out[..., :2] / np.maximum(out[..., 2:3], 1e-8)
    new = np.concatenate([out.min(axis=1), out.max(axis=1)], axis=1)
    new = _clamp_boxes(new, width, height).astype(boxes.dtype)
    keep = boxes.sum(axis=1) > 0  # empty rows stay all-zero
    return np.where(keep[:, None], new, boxes)


def affine_forward_matrix(angle, translate, scale, shear, center):
    """torchvision ``_get_inverse_affine_matrix(..., inverted=False)``: the
    forward 2x3 matrix ``T(c + t) . scale*RSS(angle, shear) . T(-c)``.
    angle / shear in degrees, translate in pixels, center in continuous
    coordinates."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [x * scale for x in (a, b, c, d)]
    mat = np.array([[m[0], m[1], 0.0], [m[2], m[3], 0.0]], np.float64)
    mat[0, 2] = mat[0, 0] * (-cx) + mat[0, 1] * (-cy) + cx + tx
    mat[1, 2] = mat[1, 0] * (-cx) + mat[1, 1] * (-cy) + cy + ty
    return mat


def sample_affine_params(rng, degrees, translate, scale, shear, width,
                         height):
    """``v2.RandomAffine._get_params`` with a numpy Generator."""
    angle = float(rng.uniform(-degrees, degrees))
    tx = int(round(rng.uniform(-translate[0] * width,
                               translate[0] * width)))
    ty = int(round(rng.uniform(-translate[1] * height,
                               translate[1] * height)))
    s = float(rng.uniform(scale[0], scale[1]))
    shear_x = float(rng.uniform(shear[0], shear[1]))
    shear_y = float(rng.uniform(shear[2], shear[3])) if len(shear) == 4 else 0.0
    return angle, (tx, ty), s, (shear_x, shear_y)


def _invert_affine(mat):
    """The inverse of a forward 2x3 affine matrix, as a 3x3, in float64
    (OpenCV's invertAffineTransform)."""
    (a, b, c), (d, e, f) = mat
    det = a * e - b * d
    inv = 1.0 / det if det != 0 else 0.0
    a2, b2, d2, e2 = e * inv, -b * inv, -d * inv, a * inv
    return np.array([[a2, b2, -a2 * c - b2 * f], [d2, e2, -d2 * c - e2 * f],
                     [0.0, 0.0, 1.0]])


def _source_coords(inverse, h: int, w: int):
    """(x, y) source positions, float64 (H, W) each, of every destination
    pixel under the 3x3 inverse map (projected)."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pts = inverse @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    den = np.where(pts[2] != 0, pts[2], 1.0)
    return (pts[0] / den).reshape(h, w), (pts[1] / den).reshape(h, w)


def _gather(video, sx, sy):
    """video (T, H, W, C) at integer source pixels (sx, sy) of shape (H, W)
    -> ((T, H, W, C), inside (H, W)); a pixel outside the frame reads
    pixel 0 and is flagged False."""
    _, h, w, c = video.shape
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    flat = np.where(inside, sy * w + sx, 0).ravel()
    out = np.take(video.reshape(video.shape[0], h * w, c), flat, axis=1)
    return out.reshape(video.shape), inside


def warp_affine_nearest(video, mat):
    """Every frame of (T, H, W, C) through the forward 2x3 `mat`, nearest
    source pixel, zero outside: the destination pixel (x, y) reads the
    source at inv(mat) @ (x, y, 1) rounded half to even, as OpenCV's
    warpAffine(INTER_NEAREST) on float frames does."""
    _, h, w = video.shape[:3]
    fx, fy = _source_coords(_invert_affine(mat), h, w)
    out, inside = _gather(video, np.rint(fx).astype(np.int64),
                          np.rint(fy).astype(np.int64))
    return np.where(inside[None, :, :, None], out, 0).astype(video.dtype)


def warp_perspective_bilinear(video, mat):
    """Every frame of (T, H, W, C) through the forward 3x3 homography
    `mat`, bilinear, zero outside: the destination pixel (x, y) reads the
    source at the projection of inv(mat) @ (x, y, 1), its four taps
    weighted in float32 and a tap outside the frame reading 0, as OpenCV's
    warpPerspective(INTER_LINEAR) on float frames does."""
    _, h, w = video.shape[:3]
    fx, fy = _source_coords(np.linalg.inv(mat), h, w)
    x0, y0 = np.floor(fx), np.floor(fy)
    ax, ay = (fx - x0).astype(np.float32), (fy - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = video.astype(np.float32, copy=False)
    out = np.zeros(src.shape, np.float32)
    one = np.float32(1.0)
    for dy, wy in ((0, one - ay), (1, ay)):
        for dx, wx in ((0, one - ax), (1, ax)):
            tap, inside = _gather(src, x0 + dx, y0 + dy)
            out += tap * np.where(inside, wy * wx, np.float32(0.0))[
                None, :, :, None]
    return out.astype(video.dtype)


def affine_video_boxes(video, boxes, rng, degrees: float = 4.0,
                       translate: Tuple[float, float] = (0.2, 0.2),
                       scale: Tuple[float, float] = (0.8, 1.2),
                       shear=(-5.0, 5.0, -5.0, 5.0)):
    """One random rotation / translation / scale / shear per clip (defaults:
    the reference's instantiation, train3dcnn.py:72)."""
    t, h, w = video.shape[:3]
    angle, (tx, ty), s, sh = sample_affine_params(
        rng, degrees, translate, scale, shear, w, h)
    # boxes live in continuous coordinates: center (0.5 w, 0.5 h); pixel
    # centres sit at integers, so the image's centre shifts by -0.5
    mat = affine_forward_matrix(angle, (tx, ty), s, sh, (0.5 * w, 0.5 * h))
    mat_img = affine_forward_matrix(angle, (tx, ty), s, sh,
                                    (0.5 * w - 0.5, 0.5 * h - 0.5))
    out = warp_affine_nearest(video, mat_img)
    if boxes is not None:
        boxes = _apply_matrix_to_boxes(boxes, mat, w, h)
    return out, boxes


def sample_perspective_endpoints(rng, distortion, width, height):
    """``v2.RandomPerspective._get_params``: displace the four
    ``(w-1, h-1)``-convention corners inward by integer amounts."""
    half_w, half_h = width // 2, height // 2
    bw = int(distortion * half_w) + 1
    bh = int(distortion * half_h) + 1
    topleft = [int(rng.integers(0, bw)), int(rng.integers(0, bh))]
    topright = [width - 1 - int(rng.integers(0, bw)),
                int(rng.integers(0, bh))]
    botright = [width - 1 - int(rng.integers(0, bw)),
                height - 1 - int(rng.integers(0, bh))]
    botleft = [int(rng.integers(0, bw)),
               height - 1 - int(rng.integers(0, bh))]
    startpoints = [[0, 0], [width - 1, 0], [width - 1, height - 1],
                   [0, height - 1]]
    endpoints = [topleft, topright, botright, botleft]
    return startpoints, endpoints


def perspective_transform(startpoints, endpoints):
    """The 3x3 homography mapping each start point onto its end point
    (OpenCV's getPerspectiveTransform): the solve of the 8-coefficient
    linear system in float64, h33 = 1."""
    a, b = [], []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        a.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        b += [ex, ey]
    coef = np.linalg.solve(np.asarray(a, np.float64),
                           np.asarray(b, np.float64))
    return np.append(coef, 1.0).reshape(3, 3)


def perspective_video_boxes(video, boxes, rng, distortion: float = 0.2,
                            p: float = 0.5):
    if rng.random() >= p:
        return video, boxes
    t, h, w = video.shape[:3]
    startpoints, endpoints = sample_perspective_endpoints(rng, distortion,
                                                          w, h)
    mat = perspective_transform(startpoints, endpoints)
    out = warp_perspective_bilinear(video, mat)
    if boxes is not None:
        boxes = _apply_matrix_to_boxes(boxes, mat, w, h, perspective=True)
    return out, boxes


def rasterize_boxes_np(boxes, height: int, width: int):
    """Host mirror of ops.video.rasterize_boxes: (T, 4) -> (T, H, W) in
    {0, 1}: both corner pixels inclusive, fractional corners widened
    outward (floor of the start, ceil of the end), as the reference's
    cv2.rectangle(..., -1) fill (datasets.py:86-107)."""
    ys = np.arange(height)
    xs = np.arange(width)
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))
    row = (ys >= np.floor(y1)) & (ys <= np.ceil(y2))
    col = (xs >= np.floor(x1)) & (xs <= np.ceil(x2))
    return (row[:, :, None] & col[:, None, :]).astype(np.float32)


class PairedVideoAugment:
    """Perspective, affine and flip with one RNG per augmenter, in the
    reference's order (train3dcnn.py:70-75: ResizeBboxes ->
    RandomPerspective -> RandomAffine -> RandomHorizontalFlip ->
    CreateBboxesMasks); the defaults are the reference's."""

    def __init__(self, hflip_p: float = 0.5, degrees: float = 4.0,
                 translate=(0.2, 0.2), scale=(0.8, 1.2),
                 shear=(-5.0, 5.0, -5.0, 5.0),
                 perspective_p: float = 0.5, distortion: float = 0.2,
                 seed: int = 0):
        self.hflip_p = hflip_p
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.perspective_p = perspective_p
        self.distortion = distortion
        self.rng = np.random.default_rng(seed)

    def __call__(self, video, boxes):
        video, boxes = perspective_video_boxes(video, boxes, self.rng,
                                               self.distortion,
                                               self.perspective_p)
        video, boxes = affine_video_boxes(video, boxes, self.rng,
                                          self.degrees, self.translate,
                                          self.scale, self.shear)
        return hflip_video_boxes(video, boxes, self.rng, self.hflip_p)
