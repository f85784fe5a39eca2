"""S3D (separable 3-D Inception) video network (the JAX package's
models/s3d.py, which follows torchvision.models.video.s3d): the
reference's third frozen video extractor, `features` + a global average
pool -> 1024-d.

Every spatial / temporal factorized conv is a conv without bias, a
BatchNorm (eps 1e-3, as torchvision's) and a ReLU.  As models/r3d.py, a
clip comes in channels-last (B, T, H, W, 3) and is permuted once to
(B, C, T, H, W), in which the convs, norms, pools and the branch concat
run.  Module names follow the JAX ones (stem0-2, inception{i},
branch0..branch3_1, spatial/temporal, conv/bn, features), so
io/from_jax.py carries the weights as they are.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .nn3d import BatchNorm3d, Conv3d, global_avg_pool, max_pool3d
from .r3d import to_channels_first
from .stochastic import Dropout


class ConvBN(nn.Module):
    def __init__(self, c_in: int, features: int, kernel: Tuple[int, int, int],
                 stride=(1, 1, 1), padding=(0, 0, 0), eps: float = 1e-3):
        super().__init__()
        self.conv = Conv3d(c_in, features, kernel, stride=stride,
                           padding=padding, bias=False, channels_first=True)
        self.bn = BatchNorm3d(features, eps=eps)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class TemporalSeparableConv(nn.Module):
    """(1, k, k) spatial then (k, 1, 1) temporal ConvBN."""

    def __init__(self, c_in: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        k, s, p = kernel, stride, padding
        self.spatial = ConvBN(c_in, features, (1, k, k), (1, s, s), (0, p, p))
        self.temporal = ConvBN(features, features, (k, 1, 1), (s, 1, 1),
                               (p, 0, 0))

    def forward(self, x):
        return self.temporal(self.spatial(x))


class SepInceptionBlock3D(nn.Module):
    def __init__(self, c_in: int, b0: int, b1_mid: int, b1: int, b2_mid: int,
                 b2: int, b3: int):
        super().__init__()
        self.branch0 = ConvBN(c_in, b0, (1, 1, 1))
        self.branch1_0 = ConvBN(c_in, b1_mid, (1, 1, 1))
        self.branch1_1 = TemporalSeparableConv(b1_mid, b1, 3, 1, 1)
        self.branch2_0 = ConvBN(c_in, b2_mid, (1, 1, 1))
        self.branch2_1 = TemporalSeparableConv(b2_mid, b2, 3, 1, 1)
        self.branch3_1 = ConvBN(c_in, b3, (1, 1, 1))
        self.out_channels = b0 + b1 + b2 + b3

    def forward(self, x):
        return torch.cat([
            self.branch0(x),
            self.branch1_1(self.branch1_0(x)),
            self.branch2_1(self.branch2_0(x)),
            self.branch3_1(max_pool3d(x, 3, 1, padding=1))], dim=1)


_INCEPTIONS = (
    (64, 96, 128, 16, 32, 32),
    (128, 128, 192, 32, 96, 64),
    "pool",
    (192, 96, 208, 16, 48, 64),
    (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64),
    (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128),
    "pool2",
    (256, 160, 320, 32, 128, 128),
    (384, 192, 384, 48, 128, 128),
)


class S3DFeatures(nn.Module):
    """(B, 3, T, H, W) -> (B, 1024, T', H', W')."""

    def __init__(self):
        super().__init__()
        self.stem0 = TemporalSeparableConv(3, 64, 7, 2, 3)
        self.stem1 = ConvBN(64, 64, (1, 1, 1))
        self.stem2 = TemporalSeparableConv(64, 192, 3, 1, 1)
        self.blocks = []  # inception names and "pool" / "pool2", in order
        c_in, idx = 192, 0
        for spec in _INCEPTIONS:
            if isinstance(spec, str):
                self.blocks.append(spec)
                continue
            block = SepInceptionBlock3D(c_in, *spec)
            self.add_module(f"inception{idx}", block)
            self.blocks.append(f"inception{idx}")
            c_in, idx = block.out_channels, idx + 1

    def forward(self, x):
        h = max_pool3d(self.stem0(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        h = self.stem2(self.stem1(h))
        h = max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name in self.blocks:
            if name == "pool":
                h = max_pool3d(h, 3, 2, 1)
            elif name == "pool2":
                h = max_pool3d(h, 2, 2, 0)
            else:
                h = getattr(self, name)(h)
        return h


class S3DExtractor(nn.Module):
    """Headless S3D: (B, T, H, W, 3) -> (B, 1024) pooled features (the
    reference's models.py:61-71)."""

    def __init__(self):
        super().__init__()
        self.features = S3DFeatures()

    def forward(self, x):
        return global_avg_pool(self.features(to_channels_first(x)))


class S3DClassifier(nn.Module):
    """Full S3D with the Kinetics conv head: an average pool (2, 7, 7) at
    stride 1, dropout, a 1x1x1 conv with bias, and the mean over (T, H,
    W)."""

    def __init__(self, class_num: int = 400, dropout: float = 0.2):
        super().__init__()
        self.features = S3DFeatures()
        self.drop = Dropout(dropout)
        self.head = Conv3d(1024, class_num, 1, channels_first=True)

    def forward(self, x):
        h = F.avg_pool3d(self.features(to_channels_first(x)), (2, 7, 7), 1)
        return global_avg_pool(self.head(self.drop(h)))
