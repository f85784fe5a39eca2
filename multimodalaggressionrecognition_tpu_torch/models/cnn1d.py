"""Raw-waveform 1-D CNN (the JAX package's models/cnn1d.py), channels-last.

  stem  Conv(1->64, k160, s40, p80) BN ReLU MaxPool4 Drop1d(.1)   L: 80000->2001->500
  b1    [Conv(64->64, k3, p1) BN ReLU] x2  MaxPool4 Drop1d(.1)    L: 500->125
  b2    [Conv(64->128) / Conv(128->128)]   MaxPool4 Drop1d(.1)    L: 125->31
  b3    [Conv(128->256) / Conv(256->256)]  MaxPool4 Drop1d(.1)    L: 31->7
  b4    [Conv(256->512) / Conv(512->512)]  Drop1d(.1)             L: 7
  classifier: mean over L -> SampleDropout(.2) -> Linear(512, classes)

In eval mode each BatchNorm is folded into its conv's epilogue; on the stem
that puts Conv + BN + ReLU into one launch of the framed-conv kernel (or,
where a gradient is needed, the kernel with the bias only and the folded
affine as torch ops).  In train mode each BatchNorm uses batch statistics
after its conv.
"""

import torch
from torch import nn

from .nn1d import BatchNorm1d, Conv1d, Dropout1d, SampleDropout, max_pool1d
from .stochastic import Dropout

# (features, kernel, stride, padding), grouped into pool blocks.
_CNN1D_BLOCKS = (
    ((64, 160, 40, 80),),
    ((64, 3, 1, 1), (64, 3, 1, 1)),
    ((128, 3, 1, 1), (128, 3, 1, 1)),
    ((256, 3, 1, 1), (256, 3, 1, 1)),
    ((512, 3, 1, 1), (512, 3, 1, 1)),
)


class CNN1DExtractor(nn.Module):
    """Conv trunk: (B, L) or (B, L, 1) waveform -> (B, T', 512) features."""

    def __init__(self, dropout: float = 0.1):
        super().__init__()
        idx, c_in = 0, 1
        for block_i, block in enumerate(_CNN1D_BLOCKS):
            for feats, k, s, p in block:
                self.add_module(f"conv{idx}", Conv1d(c_in, feats, k, s, p))
                self.add_module(f"bn{idx}", BatchNorm1d(feats))
                idx, c_in = idx + 1, feats
            self.add_module(f"drop{block_i}", Dropout1d(dropout))

    def forward(self, x):
        if x.dim() == 2:
            x = x[..., None]
        idx = 0
        for block_i, block in enumerate(_CNN1D_BLOCKS):
            for _ in block:
                conv = getattr(self, f"conv{idx}")
                bn = getattr(self, f"bn{idx}")
                if self.training:
                    x = torch.relu(bn(conv(x)))
                else:
                    x = conv(x, *bn.folded_scale_shift(), relu=True)
                idx += 1
            if block_i < len(_CNN1D_BLOCKS) - 1:
                x = max_pool1d(x, 4)
            x = getattr(self, f"drop{block_i}")(x)
        return x


class CNN1D(nn.Module):
    """Waveform classifier (reference CNN1D): logits (B, class_num)."""

    def __init__(self, class_num: int, dropout: float = 0.1,
                 classifier_dropout: float = 0.2):
        super().__init__()
        self.extractor = CNN1DExtractor(dropout)
        self.cls_drop = SampleDropout(classifier_dropout)
        self.head = nn.Linear(512, class_num)

    def forward(self, x):
        h = self.extractor(x).mean(dim=1)  # AdaptiveAvgPool1d(1) + Flatten
        return self.head(self.cls_drop(h))


class AudioCnn1DExtractorWrapper(nn.Module):
    """Conv trunk + Linear(512->hidden) ReLU Dropout(0.3): (B, L) -> (B, T', hidden)."""

    def __init__(self, hidden_size: int = 768):
        super().__init__()
        self.extractor = CNN1DExtractor()
        self.adaptor = nn.Linear(512, hidden_size)
        self.dropout = Dropout(0.3)

    def forward(self, x):
        return self.dropout(torch.relu(self.adaptor(self.extractor(x))))
