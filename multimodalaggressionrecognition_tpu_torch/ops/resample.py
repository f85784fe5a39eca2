"""Windowed-sinc polyphase resampling (the JAX package's ops/resample.py).

torchaudio.functional.resample's algorithm (gcd-reduced rates, a
Hann-windowed sinc lowpass, polyphase evaluation; lowpass_filter_width 6,
rolloff 0.99) as a kernel bank of one FIR per output phase:

    y[t*new_g + i] = sum_k kernels[i, k] * xpad[t*orig_g + k],
    xpad = pad(x, (width, width + orig_g)).

`resample_kernel` and `resample_poly_np` are plain numpy (the data path's
wav loader runs them on host threads); `resample_poly` runs the same sum on
tensors through the framed-conv kernel (ops/cuda/framed_conv.py), frame
length 2*width + orig_g, hop orig_g, one output channel per phase.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .cuda.framed_conv import framed_conv1d


@functools.lru_cache(maxsize=16)
def resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99):
    """(kernels (new_g, 2*width + orig_g) f32, width, orig_g, new_g)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig_g, new_g) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_g / base_freq))
    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = (-np.arange(new_g, dtype=np.float64)[:, None] / new_g + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t_pi = t * np.pi
    sinc = np.where(t == 0, 1.0, np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
    kernels = sinc * window * (base_freq / orig_g)
    return kernels.astype(np.float32), width, orig_g, new_g


def resample_poly_np(x, orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Resample a numpy signal (..., L): ceil(new_freq * L / orig_freq)
    samples."""
    if orig_freq == new_freq:
        return np.asarray(x)
    kernels, width, orig_g, new_g = resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    x = np.asarray(x, np.float32)
    length = x.shape[-1]
    target_len = -(-new_g * length // orig_g)
    xpad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(width, width + orig_g)])
    frame_len = kernels.shape[1]
    num_frames = length // orig_g + 1
    idx = (np.arange(num_frames)[:, None] * orig_g
           + np.arange(frame_len)[None, :])
    y = xpad[..., idx] @ kernels.T
    return y.reshape(*y.shape[:-2], -1)[..., :target_len]


def resample_poly(x, orig_freq: int, new_freq: int,
                  lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Resample a f32 tensor (..., L) on its device through the framed-conv
    kernel (its plain version for a CPU tensor); ceil(new_freq * L /
    orig_freq) samples."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig_g, new_g = resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    length = x.shape[-1]
    target_len = -(-new_g * length // orig_g)
    lead = x.shape[:-1]
    xpad = F.pad(x.reshape(-1, length), (width, width + orig_g)).contiguous()
    weight = torch.from_numpy(np.ascontiguousarray(kernels.T)).to(x.device)
    bias = torch.zeros(new_g, dtype=torch.float32, device=x.device)
    y = framed_conv1d(xpad, weight, bias, kernels.shape[1], orig_g, pad=0)
    return y.reshape(*lead, -1)[..., :target_len]  # interleave the phases
