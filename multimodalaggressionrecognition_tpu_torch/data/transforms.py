"""Host-side fixed-shape transforms: pad-or-truncate to the compiled sizes
(audio 80 000 samples, text 48x768 or 256 token ids, video 128 frames by
default)."""

from typing import Callable

import numpy as np

from ..ops.padding import pad_or_truncate


def pad_text(target_len: int = 48) -> Callable:
    def fn(x):  # (T, D) -> (target_len, D)
        return pad_or_truncate(np.asarray(x, np.float32), target_len, axis=0)

    return fn


def pad_ids(target_len: int = 256) -> Callable:
    def fn(x):  # (T,) int64 token ids -> ((target_len,) ids, kept length)
        x = np.asarray(x, np.int64).reshape(-1)
        return pad_or_truncate(x, target_len), min(len(x), target_len)

    return fn


def pad_audio(target_len: int = 80000) -> Callable:
    def fn(x):  # (L,) -> (target_len,)
        return pad_or_truncate(np.asarray(x, np.float32).reshape(-1), target_len)

    return fn


def pad_video(target_frames: int = 128) -> Callable:
    def fn(x):  # (T, H, W, C) -> (target_frames, H, W, C)
        return pad_or_truncate(np.asarray(x, np.float32), target_frames, axis=0)

    return fn
