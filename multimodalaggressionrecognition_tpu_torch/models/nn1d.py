"""1-D conv-net building blocks with torch semantics, channels-last layout.

Sequence tensors are (B, L, C), as in the JAX package (models/nn1d.py).
The waveform stem (C_in = 1) runs through the framed-conv CUDA kernel
(ops/cuda/framed_conv.py): for inference with an eval BatchNorm and ReLU
folded into its epilogue, and where a gradient is needed through its
autograd Function with the bias only.  Every other convolution is
`F.conv1d`, as the JAX package leaves those to XLA.

BatchNorm follows torch.nn.BatchNorm1d: in train mode it normalizes with the
biased batch variance and moves the running statistics (momentum 0.1) with
the unbiased one; in eval mode it uses the running statistics.  The dropouts
draw from explicit generators (models/stochastic.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.framed_conv import framed_conv1d, framed_conv1d_trainable
from .stochastic import Stochastic


class Conv1d(nn.Module):
    """Strided 1-D convolution on (B, L, C_in) -> (B, L_out, C_out).

    Weight (C_out, C_in, K) as torch's; the JAX package's frame-major
    (K*C_in, C_out) kernel converts in io/from_jax.py.  `scale`, `shift` and
    `relu` apply `act(y * scale + shift)` per output channel after the bias:
    fused into the kernel on the stem, plain ops elsewhere.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        bound = (in_channels * kernel_size) ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        if x.shape[-1] == 1:
            # (C_out, 1, K) -> (K, C_out): the kernel's (F, C_out) layout
            w = self.weight[:, 0, :].t().contiguous()
            args = (x[..., 0].contiguous(), w, self.bias, self.kernel_size,
                    self.stride, self.padding)
            if not (torch.is_grad_enabled() and (
                    x.requires_grad or self.weight.requires_grad)):
                return framed_conv1d(*args, scale=scale, shift=shift,
                                     relu=relu)
            y = framed_conv1d_trainable(*args)
        else:
            y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                         stride=self.stride, padding=self.padding
                         ).transpose(1, 2)
        if scale is not None:
            y = y * scale
        if shift is not None:
            y = y + shift
        return torch.relu(y) if relu else y


class BatchNorm1d(nn.Module):
    """torch BatchNorm1d over the channel (last) axis, eps 1e-5, momentum
    0.1."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def folded_scale_shift(self):
        """(scale, shift) with bn(y) == y * scale + shift in eval mode."""
        if self.training:
            raise RuntimeError("BatchNorm1d: only the eval mode folds")
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * inv + self.bias
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = (x - mean).square().mean(dim=axes)
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


def max_pool1d(x, window: int):
    """torch MaxPool1d(window) on (B, L, C): floor(L / window) outputs."""
    return F.max_pool1d(x.transpose(1, 2), window).transpose(1, 2)


class Dropout1d(Stochastic):
    """Channel dropout on (B, L, C): zeroes whole channels per sample."""

    def noise_shape(self, x):
        return (x.shape[0], 1, x.shape[-1])


class SampleDropout(Stochastic):
    """Drops whole rows of a (B, F) tensor (the reference's Dropout1d after
    Flatten)."""

    def noise_shape(self, x):
        return (x.shape[0], 1)
