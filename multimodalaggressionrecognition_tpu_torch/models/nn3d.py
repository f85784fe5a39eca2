"""3-D convolution with torch semantics on the channels-last layout (the JAX
package's models/nn3d.py).

Video tensors are (B, T, H, W, C).  Only the unpadded (VALID) `Conv3d` with
a bias, which Swin3D's patch embedding uses, is ported so far; it is
`F.conv3d`, as the JAX package leaves this conv to XLA.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class Conv3d(nn.Module):
    """(B, T, H, W, C_in) -> (B, T', H', W', C_out), no padding.

    Weight (C_out, C_in, kt, kh, kw) as torch's; the JAX package's
    (kt, kh, kw, C_in, C_out) kernel converts in io/from_jax.py."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride=1):
        super().__init__()
        self.kernel_size, self.stride = _triple(kernel_size), _triple(stride)
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        bound = 1.0 / math.sqrt(in_channels * math.prod(self.kernel_size))
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias,
                     stride=self.stride)
        return y.permute(0, 2, 3, 4, 1)
