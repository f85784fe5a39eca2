"""VGG11-BN image classifier (the JAX package's models/vgg.py): torchvision's
vgg11_bn, the reference's model of 3-channel spectrogram stacks.

Configuration 'A' with batch norm: conv 64 M 128 M 256 256 M 512 512 M
512 512 M (3x3 convs, padding 1), an adaptive 7x7 average pool, then the
classifier 4096-4096-classes with dropout.  The JAX model takes
channels-last (B, H, W, 3); this one runs in torch's (B, 3, H, W), so its
flatten is already torch's (C, 7, 7) order.  `F.max_pool2d` and
`F.adaptive_avg_pool2d` are the JAX package's `max_pool_nd` and
`adaptive_avg_pool_2d` (ops/video.py, whose matrices reproduce torch's
pool exactly).  Module names follow the JAX ones (conv{i}, bn{i},
fc1-fc3), so io/from_jax.py carries its weights.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear
from .nn3d import BatchNorm2d, Conv2d
from .stochastic import Dropout

_VGG11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class VGG11BN(nn.Module):
    def __init__(self, class_num: int = 1000, dropout: float = 0.5,
                 in_channels: int = 3):
        super().__init__()
        self.dropout = dropout
        self.blocks = []  # (conv, bn) pairs and "M", in order
        idx, c_in = 0, in_channels
        for v in _VGG11:
            if v == "M":
                self.blocks.append("M")
                continue
            setattr(self, f"conv{idx}", Conv2d(c_in, v, 3, padding=1))
            setattr(self, f"bn{idx}", BatchNorm2d(v))
            self.blocks.append(idx)
            idx, c_in = idx + 1, v
        self.fc1 = Linear(c_in * 49, 4096)
        self.fc2 = Linear(4096, 4096)
        self.fc3 = Linear(4096, class_num)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x):
        """(B, C, H, W) -> (B, class_num) logits."""
        for block in self.blocks:
            if block == "M":
                x = F.max_pool2d(x, 2)
            else:
                conv, bn = getattr(self, f"conv{block}"), getattr(self,
                                                                 f"bn{block}")
                x = torch.relu(bn(conv(x)))
        if x.shape[-2:] != (7, 7):
            x = F.adaptive_avg_pool2d(x.float(), 7)  # f32, as JAX's pool
        x = self.drop1(torch.relu(self.fc1(x.flatten(1))))
        x = self.drop2(torch.relu(self.fc2(x)))
        return self.fc3(x)
