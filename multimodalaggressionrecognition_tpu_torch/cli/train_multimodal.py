"""The multimodal PhysVerb configuration and model builder (the JAX
package's cli/train_multimodal.py).

Only the model side is ported: `--modalities audio,text` builds the flagship
(CNN1D audio tower + Linear 512->hidden, identity text tower, fusion
transformer, PhysVerb concat heads), and `+video` adds the frozen windowed
Swin3D-T tower.  The training loop, losses and data pipeline arrive with the
trainer slice; an unfrozen Swin tower (`--video_freeze false`) with Swin
fine-tuning.
"""

from dataclasses import dataclass

from .common import TrainConfig

SWIN_WIDTH = 768  # Swin3D-T's final width: the video tokens' width


@dataclass
class MultimodalConfig(TrainConfig):
    modalities: str = "audio,text"       # comma-separated; +video to enable
    hidden_size: int = 768
    fusion_layers: int = 1
    fusion_heads: int = 8
    adaptor_out: int = 256
    audio_samples: int = 80000
    text_tokens: int = 48
    video_frames: int = 128
    video_size: int = 112
    video_window: int = 8
    # GELU mode of the Swin MLPs: "poly" and "erf" are the exact GELU,
    # "tanh" torch's tanh approximation (ops/erf.py)
    swin_gelu: str = "poly"
    # False (fine-tuning the Swin tower) is not ported yet and raises
    video_freeze: bool = True
    batch_size: int = 32


def audio_tokens(audio_samples: int) -> int:
    """CNN1D trunk token count: the stem (k160, s40, p80) then four pools."""
    t = audio_samples // 40 + 1
    for _ in range(4):
        t //= 4
    return t


def build_model(cfg, modalities):
    """The PhysVerbModel for `modalities` (a subset of audio, text, video),
    on the CPU with torch's default initialization; the caller loads
    weights."""
    from ..models.cnn1d import AudioCnn1DExtractorWrapper
    from ..models.fusion import EqualSizedTransformerModalitiesFusion
    from ..models.physverb import (IdentityExtractor,
                                   PhysVerbClassifierConcatFeatures,
                                   PhysVerbModel)

    unknown = sorted(set(modalities) - {"audio", "text", "video"})
    if unknown:
        raise SystemExit(f"unknown modalities {unknown}: the model takes "
                         "audio, text and video")
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
    if "video" in modalities:
        from ..models.swin3d import Swin3dTExtractor
        from ..models.video_extractors import WindowedVideoExtractor

        if cfg.hidden_size != SWIN_WIDTH:
            raise ValueError(
                f"video tokens are Swin3D-T's {SWIN_WIDTH} wide and share "
                f"the fusion encoder: hidden_size must be {SWIN_WIDTH}, got "
                f"{cfg.hidden_size}")
        extractors["video"] = WindowedVideoExtractor(
            Swin3dTExtractor(gelu=cfg.swin_gelu), window=cfg.video_window,
            freeze=cfg.video_freeze)
        adaptor_sizes["video"] = (cfg.hidden_size, cfg.adaptor_out)
        feature_shapes["video"] = (cfg.video_frames // cfg.video_window,
                                   cfg.hidden_size)
    return PhysVerbModel(
        extractors=extractors,
        fusion=EqualSizedTransformerModalitiesFusion(
            cfg.fusion_layers, cfg.hidden_size, cfg.fusion_heads),
        classifier=PhysVerbClassifierConcatFeatures(
            class_num=2, adaptor_sizes=adaptor_sizes),
        feature_shapes=feature_shapes,
        modalities=tuple(sorted(modalities)),
    )
