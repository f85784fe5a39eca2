"""2-D and 3-D convolution with torch semantics (the JAX package's
models/nn3d.py), as `F.conv2d` / `F.conv3d`: the JAX package leaves these
convs to XLA.

The JAX package keeps video channels-last, (B, T, H, W, C).  `Conv3d`
takes that layout by default, and torch's (B, C, T, H, W) with
`channels_first=True`: the R3D and S3D networks permute a clip once at
their entry and run every conv, norm and pool in that layout.  Swin3D's
patch embedding, channels-last, is a product of its patches with the
weight instead (models/swin3d.PatchEmbed3d).  Images run in torch's
(B, C, H, W) layout (models/vgg.py): `Conv2d` with padding and a bias.  `BatchNorm2d` and
`BatchNorm3d` are nn1d.BatchNorm1d's parameters and semantics on the
channel axis 1.  The JAX package's `max_pool_nd` (-inf padding, floor) is
`F.max_pool2d` / `F.max_pool3d`, and its `global_avg_pool` a mean over
every axis after the channel one.

Dtypes follow the JAX package: a convolution runs in its input's dtype with
its weight and bias cast to it, and BatchNorm normalizes in f32 (`F.batch_norm`
on the widened input and affine) and returns its input's dtype.  An
extractor cast whole to bf16 (cli/extract_features.py) also has bf16
running statistics; BatchNorm then takes nn1d.BatchNorm1d's formula,
which rounds them as the JAX BatchNorm does.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .nn1d import BatchNorm1d


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class Conv2d(nn.Module):
    """(B, C_in, H, W) -> (B, C_out, H', W'), zero padding on both sides.

    Weight (C_out, C_in, kh, kw) as torch's; the JAX package's (kh, kw,
    C_in, C_out) kernel converts in io/from_jax.py."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=self.padding)


class BatchNorm2d(BatchNorm1d):
    """BatchNorm1d over the channel axis 1 of (B, C, H, W): batch
    statistics (biased variance) in train mode, moving the running ones
    with the unbiased variance, momentum 0.1; the running ones in eval."""

    def forward(self, x):
        if self.running_var.dtype != torch.float32 or (
                self.training and self.data_group is not None):
            # a cast extractor's bf16 statistics (the JAX formula's casts),
            # or the data group's global statistics
            return super().forward(x.movedim(1, -1)).movedim(-1, 1)
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(),
                            training=self.training, momentum=self.momentum,
                            eps=self.eps).to(x.dtype)


class BatchNorm3d(BatchNorm2d):
    """The same on (B, C, T, H, W): statistics over every axis but C."""


class Conv3d(nn.Module):
    """(B, T, H, W, C_in) -> (B, T', H', W', C_out), or (B, C_in, T, H, W)
    -> (B, C_out, T', H', W') with `channels_first`; zero padding on both
    sides of each axis, and no bias parameter with `bias=False` (the JAX
    `use_bias=False` has no leaf).

    Weight (C_out, C_in, kt, kh, kw) as torch's; the JAX package's
    (kt, kh, kw, C_in, C_out) kernel converts in io/from_jax.py."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride=1, padding=0, bias: bool = True,
                 channels_first: bool = False):
        super().__init__()
        self.kernel_size, self.stride = _triple(kernel_size), _triple(stride)
        self.padding, self.channels_first = _triple(padding), channels_first
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None
        bound = 1.0 / math.sqrt(in_channels * math.prod(self.kernel_size))
        nn.init.uniform_(self.weight, -bound, bound)
        if bias:
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.channels_first:
            return F.conv3d(x, weight, bias, stride=self.stride,
                            padding=self.padding)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


def max_pool3d(x, window, stride=None, padding=0):
    """torch MaxPool3d on (B, C, T, H, W): -inf padding, floor."""
    return F.max_pool3d(x, window, stride if stride is not None else window,
                        padding)


def global_avg_pool(x):
    """AdaptiveAvgPool(1) + Flatten on (B, C, ...): (B, C)."""
    return x.mean(dim=tuple(range(2, x.dim())))
