"""1-D conv-net building blocks with torch semantics, channels-last layout.

Sequence tensors are (B, L, C), as in the JAX package (models/nn1d.py).
The waveform stem (C_in = 1) runs through the framed-conv CUDA
kernel (ops/cuda/framed_conv.py), with an inference BatchNorm and ReLU
folded into its epilogue; every other convolution is `F.conv1d`, as the JAX
package leaves those to XLA.

Only eval-mode forward is ported so far: the training-mode BatchNorm and
the dropouts raise until the trainer is ported.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.framed_conv import framed_conv1d


def _eval_only(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only eval-mode forward is ported "
            "(call .eval()); training arrives with the trainer")


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
            return framed_conv1d(x[..., 0].contiguous(), w, self.bias,
                                 self.kernel_size, self.stride, self.padding,
                                 scale=scale, shift=shift, relu=relu)
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     stride=self.stride, padding=self.padding).transpose(1, 2)
        if scale is not None:
            y = y * scale
        if shift is not None:
            y = y + shift
        return torch.relu(y) if relu else y


class BatchNorm1d(nn.Module):
    """torch BatchNorm1d over the channel (last) axis, eval mode: running
    statistics, eps 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def folded_scale_shift(self):
        """(scale, shift) with bn(y) == y * scale + shift in eval mode."""
        _eval_only(self)
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        _eval_only(self)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * inv + self.bias


def max_pool1d(x, window: int):
    """torch MaxPool1d(window) on (B, L, C): floor(L / window) outputs."""
    return F.max_pool1d(x.transpose(1, 2), window).transpose(1, 2)


class Dropout1d(nn.Module):
    """Channel dropout on (B, L, C); identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        _eval_only(self)
        return x


class SampleDropout(nn.Module):
    """Drops whole rows of a (B, F) tensor (the reference's Dropout1d after
    Flatten); identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        _eval_only(self)
        return x
