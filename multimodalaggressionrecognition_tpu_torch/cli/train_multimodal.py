"""The multimodal PhysVerb configuration and model builder (the JAX
package's cli/train_multimodal.py).

Only the model side is ported: `--modalities audio,text` builds the flagship
(CNN1D audio tower + Linear 512->hidden, identity text tower, fusion
transformer, PhysVerb concat heads).  The training loop, losses and data
pipeline arrive with the trainer slice; the video tower with the video
slice.
"""

from dataclasses import dataclass

from .common import TrainConfig


@dataclass
class MultimodalConfig(TrainConfig):
    modalities: str = "audio,text"       # comma-separated
    hidden_size: int = 768
    fusion_layers: int = 1
    fusion_heads: int = 8
    adaptor_out: int = 256
    audio_samples: int = 80000
    text_tokens: int = 48
    batch_size: int = 32


def audio_tokens(audio_samples: int) -> int:
    """CNN1D trunk token count: the stem (k160, s40, p80) then four pools."""
    t = audio_samples // 40 + 1
    for _ in range(4):
        t //= 4
    return t


def build_model(cfg, modalities):
    """The PhysVerbModel for `modalities` (a subset of audio, text), on the
    CPU with torch's default initialization; the caller loads weights."""
    from ..models.cnn1d import AudioCnn1DExtractorWrapper
    from ..models.fusion import EqualSizedTransformerModalitiesFusion
    from ..models.physverb import (IdentityExtractor,
                                   PhysVerbClassifierConcatFeatures,
                                   PhysVerbModel)

    unknown = sorted(set(modalities) - {"audio", "text"})
    if unknown:
        raise SystemExit(
            f"modalities {unknown} are not ported yet: the video tower "
            "(windowed Swin3D-T) arrives with the video slice")
    extractors = {}
    adaptor_sizes = {}
    feature_shapes = {}
    if "audio" in modalities:
        extractors["audio"] = AudioCnn1DExtractorWrapper(cfg.hidden_size)
        adaptor_sizes["audio"] = (cfg.hidden_size, cfg.adaptor_out)
        feature_shapes["audio"] = (audio_tokens(cfg.audio_samples),
                                   cfg.hidden_size)
    if "text" in modalities:
        extractors["text"] = IdentityExtractor()
        adaptor_sizes["text"] = (cfg.hidden_size, cfg.adaptor_out)
        feature_shapes["text"] = (cfg.text_tokens, cfg.hidden_size)
    return PhysVerbModel(
        extractors=extractors,
        fusion=EqualSizedTransformerModalitiesFusion(
            cfg.fusion_layers, cfg.hidden_size, cfg.fusion_heads),
        classifier=PhysVerbClassifierConcatFeatures(
            class_num=2, adaptor_sizes=adaptor_sizes),
        feature_shapes=feature_shapes,
        modalities=tuple(sorted(modalities)),
    )
