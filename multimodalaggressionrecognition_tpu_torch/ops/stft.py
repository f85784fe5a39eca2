"""Power spectrogram and SpecAugment-style masks (the JAX package's
ops/stft.py), replacing torchaudio's `Spectrogram(n_fft=512)`,
`FrequencyMasking` and `TimeMasking`.

torchaudio's defaults: win_length = n_fft, hop = n_fft // 2, a periodic
Hann window, center=True with reflect padding, onesided, power 2.  The
STFT is the framed-conv kernel (ops/cuda/framed_conv.py) against the
Hann-windowed DFT basis [real | imag] (n_fft, 2 * n_freq): each frame's
real and imaginary parts come out of one launch, and neither the padded
frame matrix nor a complex tensor reaches device memory.  The basis is a
constant, built once per device by its caller (`dft_basis`).

The masks draw one (width, start) per call, shared by the whole batch, as
floats: width ~ U[0, mask_param), start ~ U[0, size - width), and a row or
column i is zeroed when start <= i < start + width.  The draw comes from an
explicit generator and stays on the device.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .cuda.framed_conv import framed_conv1d


@functools.lru_cache(maxsize=8)
def _dft_bases_np(n_fft: int):
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_freq)[None, :]
    angle = -2.0 * np.pi * n * f / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    real = np.cos(angle) * window[:, None]
    imag = np.sin(angle) * window[:, None]
    return real.astype(np.float32), imag.astype(np.float32)


def dft_basis(n_fft: int, device=None) -> torch.Tensor:
    """The windowed DFT basis [real | imag], (n_fft, 2 * (n_fft//2 + 1))
    f32, contiguous on `device`: the framed-conv kernel's weight."""
    return torch.from_numpy(np.concatenate(_dft_bases_np(n_fft), axis=1)).to(
        device)


def spectrogram(x, n_fft: int = 512, hop: int | None = None,
                power: float = 2.0, basis=None):
    """Power spectrogram of a signal (..., L) -> (..., n_freq, T) in f32,
    with T = L // hop + 1: a bf16 signal widens exactly and the result is
    f32, as the JAX op's f32 products return.  `basis` is
    `dft_basis(n_fft)` on x's device (built here when not given)."""
    hop = n_fft // 2 if hop is None else hop
    pad = n_fft // 2
    n_freq = n_fft // 2 + 1
    if basis is None:
        basis = dft_basis(n_fft, x.device)
    lead = x.shape[:-1]
    xpad = F.pad(x.reshape(-1, x.shape[-1]).float(), (pad, pad),
                 mode="reflect")
    y = framed_conv1d(xpad.contiguous(), basis, basis.new_zeros(2 * n_freq),
                      n_fft, hop, pad=0)  # (B, T, 2 * n_freq)
    spec = y[..., :n_freq].square() + y[..., n_freq:].square()
    if power != 2.0:
        spec = spec.pow(power / 2.0)
    return spec.reshape(*lead, *spec.shape[1:]).transpose(-1, -2)


def draw_axis_mask(size: int, mask_param: int, generator=None, device=None):
    """One mask draw, as 0-d f32 tensors on `device`: width ~ U[0,
    mask_param), then start ~ U[0, size - width)."""
    u = torch.rand(2, generator=generator, device=device)
    width = u[0] * float(mask_param)
    return width, u[1] * (float(size) - width)


def apply_axis_mask(x, width, start, axis: int):
    """x with the indices i of `axis` where start <= i < start + width
    zeroed, the same for every row of the batch."""
    size = x.shape[axis]
    idx = torch.arange(size, dtype=torch.float32, device=x.device)
    keep = (idx < start) | (idx >= start + width)
    shape = [1] * x.dim()
    shape[axis] = size
    return x * keep.reshape(shape).to(x.dtype)


def freq_mask(spec, mask_param: int, generator=None):
    """torchaudio's FrequencyMasking on (..., F, T)."""
    axis = spec.dim() - 2
    return apply_axis_mask(spec, *draw_axis_mask(
        spec.shape[axis], mask_param, generator, spec.device), axis)


def time_mask(spec, mask_param: int, generator=None):
    """torchaudio's TimeMasking on (..., F, T)."""
    axis = spec.dim() - 1
    return apply_axis_mask(spec, *draw_axis_mask(
        spec.shape[axis], mask_param, generator, spec.device), axis)
