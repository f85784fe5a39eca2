"""Clip-directory video dataset: frames + per-frame person boxes (the JAX
package's data/video_clips.py).

The reference's `VideoBboxesDataset` family (reference
datasets.py:353-441): each clip lives in its own directory
`<...>!person,X!(t0,t1)!LABEL/` holding `video.pt` or `video.npy` (or
`video.mp4`) and `bboxes.npy`; the 4-class Russian labels
{'Нет', 'Захваты', 'Толчки', 'Удары'} map to ids, and the 2-class variant
collapses the three aggressive ones (datasets.py:354, 372).  On host
threads a clip is loaded, augmented (data/augment.py, train only),
resized to `size` by a plain bilinear resize (cv2.resize's INTER_LINEAR
without antialias, as the JAX package calls it: ops/video.py's
`antialias=False` matrices in numpy), its boxes scaled alike and
rasterized into a mask, and frames and mask zero-padded or cut to
`frame_num`.

`.mp4` clips decode through FFmpeg with the native library
(data/native.py) where it builds, else with OpenCV, imported on first use,
and raise where neither is there.  `.pt` and `.npy` clips need neither.
"""

import os
from typing import Optional

import numpy as np

from ..ops.padding import pad_or_truncate
from ..ops.video import _resize_matrix_np
from .augment import PairedVideoAugment, rasterize_boxes_np

LABELS_4CLASS = {"Нет": 0, "Захваты": 1, "Толчки": 2, "Удары": 3}
LABELS_2CLASS = {"Нет": 0, "Захваты": 1, "Толчки": 1, "Удары": 1}


def read_video_cv2(path: str, start: Optional[int] = None,
                   end: Optional[int] = None):
    """Decode a video file to (T, H, W, 3) RGB float32 in [0, 1] with
    OpenCV (the reference's `read_video_frames_opencv`), frames
    [start, end) when given."""
    try:
        import cv2
    except ImportError as err:
        raise ImportError(
            f"{path}: decoding a video file needs OpenCV (cv2), which is not "
            "installed; store the clip as video.pt or video.npy "
            "((T, C, H, W) or (T, H, W, C) frames) instead") from err
    cap = cv2.VideoCapture(path)
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if start is not None and idx < start:
            idx += 1
            continue
        if end is not None and idx >= end:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        idx += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.float32) / 255.0


def read_video(path: str, start: Optional[int] = None,
               end: Optional[int] = None):
    """(T, H, W, 3) RGB float32 in [0, 1], frames [start, end) when given:
    the native FFmpeg decoder (data/native.py) where it builds, else
    OpenCV.  Both decode through FFmpeg; their frames differ only by the
    YUV -> RGB conversion's rounding."""
    from . import native

    if not native.video_available():
        return read_video_cv2(path, start, end)
    v = native.video_read(path, max_frames=end or 0)
    if start:
        v = v[start:]
    if v.shape[0] == 0:
        raise IOError(f"no frames decoded from {path}")
    return v.astype(np.float32) / 255.0


def _read_frames(clip: str):
    """A clip dir's frames as (T, H, W, C) float32, [0, 1] when stored as
    0..255."""
    mp4 = os.path.join(clip, "video.mp4")
    if os.path.exists(mp4):
        return read_video(mp4)
    npy = os.path.join(clip, "video.npy")
    if os.path.exists(npy):
        video = np.load(npy).astype(np.float32)
    else:
        import torch

        video = np.asarray(torch.load(os.path.join(clip, "video.pt"),
                                      map_location="cpu", weights_only=True),
                           np.float32)
    if video.ndim == 4 and video.shape[1] in (1, 3):
        video = video.transpose(0, 2, 3, 1)
    if video.max() > 2.0:
        video = video / 255.0
    return video


def resize_frames(video, size: int):
    """(T, H, W, C) -> (T, size, size, C): plain bilinear (half-pixel
    centres, two taps, border clamped, no antialias)."""
    wh = _resize_matrix_np(video.shape[1], size, False)
    ww = _resize_matrix_np(video.shape[2], size, False)
    # optimize: two BLAS contractions; numpy's default single loop over
    # all six indices takes ~3 s a frame at 144 -> 112 px
    return np.einsum("oh,thwc,pw->topc", wh, video, ww,
                     optimize=True).astype(np.float32)


class ClipDirSource:
    """Clip dirs -> batches of {video, mask} + labels.

    The label is the last `!`-separated token of the directory name,
    through `label_dict` (default 4-class)."""

    def __init__(self, root: str, frame_num: int = 32, size: int = 112,
                 label_dict=None, augment: Optional[PairedVideoAugment] = None):
        self.root = root
        self.frame_num = frame_num
        self.size = size
        self.label_dict = dict(label_dict or LABELS_4CLASS)
        self.augment = augment
        self.clip_dirs = sorted(d for d in os.listdir(root)
                                if os.path.isdir(os.path.join(root, d)))

    def __len__(self):
        return len(self.clip_dirs)

    def _label(self, name: str) -> int:
        return self.label_dict[name.split("!")[-1]]

    def labels(self):
        return np.asarray([self._label(d) for d in self.clip_dirs])

    def load(self, idx: int):
        """(frames (frame_num, size, size, C), mask (frame_num, size, size,
        1), label)."""
        name = self.clip_dirs[idx]
        clip = os.path.join(self.root, name)
        video = _read_frames(clip)
        boxes = np.load(os.path.join(clip, "bboxes.npy")).astype(np.float32)
        boxes = boxes[:video.shape[0]]
        if self.augment is not None:
            video, boxes = self.augment(video, boxes)
        h, w = video.shape[1:3]
        if (h, w) != (self.size, self.size):
            video = resize_frames(video, self.size)
            sx, sy = self.size / w, self.size / h
            boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
        mask = rasterize_boxes_np(boxes, self.size, self.size)[..., None]
        mask = pad_or_truncate(mask, self.frame_num, axis=0)
        video = pad_or_truncate(video, self.frame_num, axis=0)
        return video, mask, self._label(name)

    def build_batch(self, indices, pad_to: Optional[int] = None):
        """A fixed-shape batch, padded to `pad_to` rows by repeating the
        first clip with mask 0."""
        samples = [self.load(i) for i in indices]
        n = len(samples)
        total = pad_to or n
        smask = np.zeros((total,), np.float32)
        smask[:n] = 1.0
        while len(samples) < total:
            samples.append(samples[0])
        video = {"data": np.stack([s[0] for s in samples]),
                 "mask": np.stack([s[1] for s in samples]),
                 "present": smask.copy()}
        labels = np.asarray([s[2] for s in samples], np.int32)
        return {"modalities": {"video": video},
                "labels": {"main": labels},
                "label_mask": {"main": smask.copy()},
                "sample_mask": smask}
