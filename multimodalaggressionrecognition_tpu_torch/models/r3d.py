"""R3D-18 (3-D ResNet-18) video models (the JAX package's models/r3d.py,
which follows torchvision.models.video.r3d_18):

  stem   Conv3d(3->64, k=(3,7,7), s=(1,2,2), p=(1,3,3), no bias) BN ReLU
  layer1 2 x BasicBlock(64)        layer2 2 x BasicBlock(128, s=2)
  layer3 2 x BasicBlock(256, s=2)  layer4 2 x BasicBlock(512, s=2)
  head   global avg pool -> fc

A clip comes in channels-last, (B, T, H, W, 3), as in the JAX package, and
is permuted once to torch's (B, C, T, H, W), in which every conv (cuDNN,
`F.conv3d`), BatchNorm and pool runs.  The stem is the plain strided conv:
the JAX package computes it through a 2x2 space-to-depth rewrite that only
serves the TPU's lane width, and holds the two equal in its own tests; the
kernel is the same parameter, `stem/conv/kernel`, either way.

`R3DWithBboxes` blends a person-bbox mask pyramid into the activations
before the stem and before every layer: the 1-channel mask is
nearest-resized to the stage's (T, H, W) from the previous stage's mask and
h' = (1 - alpha) * h + alpha * mask, broadcast over C (the reference's
models.py:325-334).  Module names follow the JAX ones (stem, layer{i}_{j},
conv1/bn1/conv2/bn2, downsample_conv/_bn, fc1, fc2, trunk), so
io/from_jax.py carries the weights as they are.
"""

from typing import Tuple

import torch
from torch import nn

from .layers import Linear
from .nn3d import BatchNorm3d, Conv3d, global_avg_pool
from .stochastic import Dropout


def _conv(c_in, c_out, kernel, stride=1, padding=0):
    return Conv3d(c_in, c_out, kernel, stride=stride, padding=padding,
                  bias=False, channels_first=True)


def to_channels_first(x):
    """(B, T, H, W, C) -> (B, C, T, H, W), contiguous."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


class BasicBlock3d(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, stride, 1)
        self.bn1 = BatchNorm3d(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm3d(features)
        self.downsample = stride != 1 or c_in != features
        if self.downsample:
            self.downsample_conv = _conv(c_in, features, 1, stride)
            self.downsample_bn = BatchNorm3d(features)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return torch.relu(h + identity)


class R3DStem(nn.Module):
    """Stem conv 3 -> 64, k=(3,7,7), s=(1,2,2), p=(1,3,3), BN, ReLU."""

    def __init__(self):
        super().__init__()
        self.conv = _conv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3))
        self.bn = BatchNorm3d(64)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


_LAYERS: Tuple[Tuple[int, int], ...] = ((64, 1), (128, 2), (256, 2), (512, 2))


def _add_layers(module: nn.Module):
    """stem, then layer{i}_0 (strided) and layer{i}_1 of each stage."""
    module.stem = R3DStem()
    c_in = 64
    for i, (feats, stride) in enumerate(_LAYERS, start=1):
        setattr(module, f"layer{i}_0", BasicBlock3d(c_in, feats, stride))
        setattr(module, f"layer{i}_1", BasicBlock3d(feats, feats))
        c_in = feats


def _stages(module: nn.Module):
    """The stem, then each layer's two blocks: the modules of each stage,
    run in turn."""
    yield (module.stem,)
    for i in range(1, len(_LAYERS) + 1):
        yield getattr(module, f"layer{i}_0"), getattr(module, f"layer{i}_1")


class R3D18Trunk(nn.Module):
    """(B, 3, T, H, W) -> (B, 512, T', H', W') feature volume."""

    def __init__(self):
        super().__init__()
        _add_layers(self)

    def forward(self, x):
        for stage in _stages(self):
            for block in stage:
                x = block(x)
        return x


class R3D18Extractor(nn.Module):
    """Headless r3d_18: (B, T, H, W, 3) -> (B, 512) pooled features (the
    frozen-extractor slot)."""

    def __init__(self):
        super().__init__()
        self.trunk = R3D18Trunk()

    def forward(self, x):
        return global_avg_pool(self.trunk(to_channels_first(x)))


class R3D18Classifier(nn.Module):
    """Full r3d_18 with the Kinetics fc head: (B, T, H, W, 3) -> logits."""

    def __init__(self, class_num: int = 400):
        super().__init__()
        self.trunk = R3D18Trunk()
        self.fc = Linear(512, class_num)

    def forward(self, x):
        return self.fc(global_avg_pool(self.trunk(to_channels_first(x))))


def _resize_nearest_3d(mask, t: int, h: int, w: int):
    """torch F.interpolate(mode='nearest') over the (T, H, W) axes of a
    (B, C, T, H, W) mask: source index floor(i * in / out).  Where `out`
    divides `in` that is every (in // out)-th element, a strided slice;
    otherwise an index gather of arange(out) * in // out."""
    for axis, out in ((2, t), (3, h), (4, w)):
        inp = mask.shape[axis]
        if inp == out:
            continue
        if inp % out == 0:
            step = [slice(None)] * mask.dim()
            step[axis] = slice(None, None, inp // out)
            mask = mask[tuple(step)]
        else:
            idx = torch.arange(out, device=mask.device) * inp // out
            mask = mask.index_select(axis, idx)
    return mask


class R3DWithBboxes(nn.Module):
    """The R3D-18 stages with the bbox-mask blend before each, then global
    average pool, fc1 (128), ReLU, dropout and fc2.

    frames (B, T, H, W, 3) and mask (B, T, H, W, 1) in {0, 1} or None ->
    logits (B, class_num).  The dropout draws from its explicit generator
    (models/stochastic.py) in train mode."""

    def __init__(self, class_num: int, alpha: float = 0.4,
                 dropout: float = 0.4):
        super().__init__()
        self.alpha = alpha
        _add_layers(self)
        self.fc1 = Linear(512, 128)
        self.drop = Dropout(dropout)
        self.fc2 = Linear(128, class_num)

    def forward(self, frames, mask=None):
        h = to_channels_first(frames)
        if mask is not None:
            mask = to_channels_first(mask)
        for stage in _stages(self):
            if mask is not None:
                if mask.shape[2:] != h.shape[2:]:
                    mask = _resize_nearest_3d(mask, *h.shape[2:])
                h = (1.0 - self.alpha) * h + self.alpha * mask
            for block in stage:
                h = block(h)
        h = torch.relu(self.fc1(global_avg_pool(h)))
        return self.fc2(self.drop(h))


class R3D(R3DWithBboxes):
    """The mask-free variant (the reference's models.py:336-342)."""

    def forward(self, frames, mask=None):
        return super().forward(frames, None)
