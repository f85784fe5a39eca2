"""The audio+text two-tower model (the JAX package's models/audiotext.py
`AudioTextualModel`, the model of cli/train_audio_text.py).

Each tower maps its modality to a (B, T, H) feature sequence; both are
mean-pooled over T and concatenated, then Linear(2H, H) -> ReLU -> Dropout
-> Linear(H, 256) -> ReLU -> Dropout -> Linear(256, classes).  The JAX
module's sibling `MultimodalModel` (per-stream classifiers) runs on no CLI
path and is not ported (ROADMAP.md, queue 1 item 9).
"""

import torch
from torch import nn

from .layers import Linear
from .stochastic import Dropout


class AudioTextualModel(nn.Module):
    """{'audio': {'data'}, 'text': {'data'}} -> logits (B, class_num)."""

    def __init__(self, audio_extractor: nn.Module, text_extractor: nn.Module,
                 hidden_size: int = 768, class_num: int = 2,
                 dropout: float = 0.3):
        super().__init__()
        self.audio_extractor = audio_extractor
        self.text_extractor = text_extractor
        self.fusion_fc = Linear(2 * hidden_size, hidden_size)
        self.cls_fc1 = Linear(hidden_size, 256)
        self.cls_fc2 = Linear(256, class_num)
        self.dropout = Dropout(dropout)

    def forward(self, modalities):
        audio = self.audio_extractor(modalities["audio"]["data"])
        text = self.text_extractor(modalities["text"]["data"])
        h = torch.cat([audio.mean(dim=1), text.mean(dim=1)], dim=-1)
        h = self.dropout(torch.relu(self.fusion_fc(h)))
        h = self.dropout(torch.relu(self.cls_fc1(h)))
        return self.cls_fc2(h)
