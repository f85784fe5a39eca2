"""The audio+text two-tower model and the per-stream multimodal wrapper
(the JAX package's models/audiotext.py).

- `AudioTextualModel` (the model of cli/train_audio_text.py): each tower
  maps its modality to a (B, T, H) feature sequence; both are mean-pooled
  over T and concatenated, then Linear(2H, H) -> ReLU -> Dropout ->
  Linear(H, 256) -> ReLU -> Dropout -> Linear(256, classes);
- `MultimodalModel`: a PhysVerbModel with one classifier per fused stream,
  keyed by the name of the fused feature it reads -> {name: logits}.
"""

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from .layers import Linear
from .physverb import PhysVerbModel
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


class MultimodalModel(PhysVerbModel):
    """extractors -> (zero stubs) -> fusion -> {name: classifiers[name](
    fused[name])}; `head_names()` in the order `classifiers` gives."""

    def __init__(self, extractors: Mapping[str, Optional[nn.Module]],
                 classifiers: Mapping[str, nn.Module],
                 fusion: Optional[nn.Module] = None,
                 feature_shapes: Optional[Mapping[str, Tuple[int, int]]] = None,
                 modalities: Tuple[str, ...] = ("audio", "text", "video"),
                 classifier: Optional[nn.Module] = None):
        super().__init__(extractors, classifier, fusion, feature_shapes,
                         modalities)
        self.classifiers = nn.ModuleDict(classifiers)

    def forward(self, batch):
        feats = self.fused_features(batch)
        return {name: clf(feats[name]) for name, clf in self.classifiers.items()}

    def head_names(self):
        return list(self.classifiers.keys())
