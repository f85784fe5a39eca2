"""Fixed-shape length normalization (numpy; the serving pads).

Every variable-length modality is truncated or zero-padded along its leading
time axis to the static length the model was built for.
"""

import numpy as np


def pad_or_truncate(x: np.ndarray, target_len: int, axis: int = 0):
    """Pad with zeros (at the end) or truncate `x` along `axis` to `target_len`."""
    length = x.shape[axis]
    if length == target_len:
        return x
    if length > target_len:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, target_len)
        return x[tuple(idx)]
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, target_len - length)
    return np.pad(x, pad_widths)
