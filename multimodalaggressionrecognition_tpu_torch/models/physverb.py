"""The multimodal PhysVerb model and its classifier heads (the JAX package's
models/physverb.py).

`PhysVerbModel` = per-modality extractors with the EMPTY protocol -> fusion
-> per-aggression-type heads.  A batch carries only the present modalities;
absent ones become static zero feature stubs (`feature_shapes`), and a
per-row {0,1} `present` mask zeroes the features of absent rows — padded
serving rows included.  A modality whose batch entry carries `lengths`
(token ids) hands them to its extractor beside its data.  A stub is f32
under any compute dtype, as the JAX package's: under bf16 it promotes that
forward's fusion and heads to f32, which run on the bf16-rounded weights.
"""

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import backward_mark, span
from .layers import Linear
from .stochastic import Dropout

MODALITY2AGGR = {"video": "phys", "text": "verb", "audio": "verb"}


class IdentityExtractor(nn.Module):
    """Pass-through extractor (the reference's text tower)."""

    def forward(self, x):
        return x


class PhysVerbClassifier(nn.Module):
    """Per-modality adaptor + per-aggr-type concat heads.

    adaptor_m = Linear(in, out) -> Dropout -> ReLU -> mean over time
    For each aggression type, the adapted features of its modalities are
    concatenated in sorted modality order; head = Linear(D, D//3) -> ReLU ->
    Dropout -> Linear(D//3, classes).
    """

    def __init__(self, class_num: int,
                 adaptor_sizes: Mapping[str, Tuple[int, int]],
                 modality2aggr: Optional[Mapping[str, str]] = None,
                 dropout: float = 0.3):
        super().__init__()
        self.adaptor_sizes = dict(adaptor_sizes)
        self.m2a = dict(modality2aggr or MODALITY2AGGR)
        self.dropout = Dropout(dropout)
        for name in sorted(self.adaptor_sizes):
            self.add_module(f"adaptor_{name}",
                            Linear(*self.adaptor_sizes[name]))
        for aggr, in_dim in self.head_in_dims().items():
            self.add_module(f"head_{aggr}_fc1", Linear(in_dim, in_dim // 3))
            self.add_module(f"head_{aggr}_fc2", Linear(in_dim // 3, class_num))

    def head_names(self):
        """The aggression types of the configured modalities, in sorted
        modality order."""
        seen = []
        for m in sorted(self.adaptor_sizes):
            if self.m2a[m] not in seen:
                seen.append(self.m2a[m])
        return seen

    def head_in_dims(self) -> Dict[str, int]:
        """{head: input width}: the summed adaptor widths of the head's
        modalities."""
        dims: Dict[str, int] = {}
        for m in sorted(self.adaptor_sizes):
            dims[self.m2a[m]] = dims.get(self.m2a[m], 0) + self.adaptor_sizes[m][1]
        return dims

    def _adapt(self, feats):
        return {name: torch.relu(self.dropout(
            getattr(self, f"adaptor_{name}")(feats[name]))).mean(dim=1)
            for name in sorted(feats)}

    def _head(self, aggr_type, x):
        h = torch.relu(getattr(self, f"head_{aggr_type}_fc1")(x))
        return getattr(self, f"head_{aggr_type}_fc2")(self.dropout(h))

    def forward(self, feats: Dict[str, torch.Tensor]):
        adapted = self._adapt(feats)
        grouped: Dict[str, list] = {}
        for name in sorted(adapted):
            grouped.setdefault(self.m2a[name], []).append(adapted[name])
        return {aggr: self._head(aggr, torch.cat(parts, dim=1))
                for aggr, parts in grouped.items()}


class PhysVerbClassifierConcatFeatures(PhysVerbClassifier):
    """Every aggr-type head sees the concat of ALL adapted modalities — the
    live train_multimodal heads.  Heads exist for every aggr type in
    `modality2aggr`, whichever modalities are configured."""

    def head_names(self):
        seen = []
        for aggr in self.m2a.values():
            if aggr not in seen:
                seen.append(aggr)
        return seen

    def head_in_dims(self) -> Dict[str, int]:
        total = sum(out for _, out in self.adaptor_sizes.values())
        return {aggr: total for aggr in self.head_names()}

    def forward(self, feats: Dict[str, torch.Tensor]):
        adapted = self._adapt(feats)
        x = torch.cat([adapted[n] for n in sorted(adapted)], dim=1)
        return {aggr: self._head(aggr, x) for aggr in self.head_names()}


class PhysVerbClassifierAddFeatures(PhysVerbClassifier):
    """Every head sees the element-wise sum of the adapted modalities (in
    sorted order), so every adaptor has the same output width.  The
    reference's version was dead code; this is the JAX package's working
    equivalent of its intent."""

    def head_in_dims(self) -> Dict[str, int]:
        widths = {out for _, out in self.adaptor_sizes.values()}
        if len(widths) != 1:
            raise ValueError(f"summed adaptors need one output width, got "
                             f"{dict(self.adaptor_sizes)}")
        width = widths.pop()
        return {aggr: width for aggr in self.head_names()}

    def forward(self, feats: Dict[str, torch.Tensor]):
        adapted = self._adapt(feats)
        x = sum(adapted[n] for n in sorted(adapted))
        return {aggr: self._head(aggr, x) for aggr in self.head_names()}


class PhysVerbModel(nn.Module):
    """extractors -> (EMPTY-aware zero stubs) -> fusion -> PhysVerb heads.

    `batch` maps modality name -> {'data': tensor, 'present': (B,) 0/1}.
    Modalities in `modalities` but absent from `batch` contribute a zero
    stub of `feature_shapes[name]`.  Output: {aggr_type: logits}.
    `classifier` may be None in a subclass that classifies otherwise
    (models/audiotext.MultimodalModel).
    """

    def __init__(self, extractors: Mapping[str, Optional[nn.Module]],
                 classifier: Optional[nn.Module],
                 fusion: Optional[nn.Module] = None,
                 feature_shapes: Optional[Mapping[str, Tuple[int, int]]] = None,
                 modalities: Tuple[str, ...] = ("audio", "text", "video")):
        super().__init__()
        self.extractors = nn.ModuleDict(
            {k: v for k, v in extractors.items() if v is not None})
        self.classifier = classifier
        self.fusion = fusion
        self.feature_shapes = dict(feature_shapes or {})
        self.modalities = tuple(modalities)

    def extract_features(self, batch):
        first = next(iter(batch.values()))["data"]
        feats = {}
        for name in sorted(self.modalities):
            with span("forward." + name, device=True):
                if name in batch:
                    data = batch[name]["data"]
                    # a token-id text carries its lengths beside its ids
                    args = ((data, batch[name]["lengths"])
                            if "lengths" in batch[name] else (data,))
                    f = (self.extractors[name](*args)
                         if name in self.extractors else data)
                    backward_mark(f, "backward." + name)
                    present = batch[name].get("present")
                    if present is not None:
                        f = f * present[:, None, None].to(f.dtype)
                    feats[name] = f
                else:
                    t, d = self.feature_shapes[name]
                    feats[name] = torch.zeros((first.shape[0], t, d),
                                              device=first.device)
        return feats

    def fused_features(self, batch):
        """The (fused) per-modality features the classifier reads."""
        feats = self.extract_features(batch)
        if self.fusion is None:
            return feats
        with span("forward.fusion", device=True):
            return self.fusion(feats)

    def forward(self, batch):
        feats = self.fused_features(batch)
        with span("forward.heads", device=True):
            return self.classifier(feats)

    def head_names(self):
        return self.classifier.head_names()
