"""Multimodal PhysVerb training (the JAX package's cli/train_multimodal.py).

Pipeline: time-intervals table + cluster split -> aggr-type-homogeneous
batches with the EMPTY protocol -> PhysVerbModel (CNN1D audio tower +
Linear 512->hidden, identity text tower, optional windowed Swin3D-T video
tower, frozen or fine-tuned) -> fusion transformer -> PhysVerb concat heads,
with focal loss ('phys', inverse-frequency alpha) + CE ('verb'), Adam and
best-UAR checkpoints.  Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_multimodal \
      --dataset_root data/avabos --modalities audio,text,video \
      --video_freeze false --synthetic
"""

from dataclasses import dataclass

import numpy as np

from .common import (TrainConfig, build_trainer, ensure_dataset,
                     parse_config, run_training)

SWIN_WIDTH = 768  # Swin3D-T's final width: the video tokens' width


@dataclass
class MultimodalConfig(TrainConfig):
    model_name: str = "multimodal_physverb"
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
    # False fine-tunes the Swin tower instead of freezing it
    video_freeze: bool = True
    # when fine-tuning: per-block gradient checkpointing of the Swin tower
    # (recompute each block's inside in the backward), policy "none" (save
    # nothing; "dots" is not ported)
    video_remat: bool = True
    video_remat_policy: str = "none"
    focal_gamma: float = 2.0
    batch_size: int = 32


def class_weights_from_df(df, label_col):
    """Inverse-frequency alpha weights (reference train_multimodal.py:467-486)."""
    labels = df[label_col].map({"NOAGGR": 0, "AGGR": 1}).dropna()
    counts = np.bincount(labels.astype(int), minlength=2).astype(np.float64)
    weights = counts.sum() / np.maximum(counts, 1.0)
    return tuple((weights / weights.sum()).tolist())


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
        remat = cfg.video_remat and not cfg.video_freeze
        extractors["video"] = WindowedVideoExtractor(
            Swin3dTExtractor(gelu=cfg.swin_gelu, remat=remat,
                             remat_policy=cfg.video_remat_policy),
            window=cfg.video_window, freeze=cfg.video_freeze)
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


def make_loaders(cfg, df, split, modalities):
    from ..data.avabos import MultimodalSource, split_by_clusters
    from ..data.pipeline import BatchLoader
    from ..data.sampler import AggrBatchSampler
    from ..data.transforms import pad_audio, pad_text, pad_video

    transforms = {"text": pad_text(cfg.text_tokens),
                  "audio": pad_audio(cfg.audio_samples),
                  "video": pad_video(cfg.video_frames)}
    loaders = []
    for clusters, shuffle in ((split["train"], True), (split["test"], False)):
        d = split_by_clusters(df, clusters)
        src = MultimodalSource(d, cfg.dataset_root, modalities,
                               transforms=transforms)
        sampler = AggrBatchSampler(d["aggr_type"].to_numpy(), cfg.batch_size,
                                   shuffle=shuffle, seed=cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(MultimodalConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    modalities = tuple(cfg.modalities.split(","))
    df, split = ensure_dataset(cfg)
    train_loader, test_loader = make_loaders(cfg, df, split, modalities)
    model = seeded_init_(build_model(cfg, modalities), cfg.seed)
    loss_specs = {
        "phys": LossSpec("focal",
                         class_weights=class_weights_from_df(
                             df, "phys_aggr_label"),
                         gamma=cfg.focal_gamma),
        "verb": LossSpec("ce"),
    }
    trainer = build_trainer(cfg, model, loss_specs, train_loader, test_loader)
    return run_training(cfg, trainer)


if __name__ == "__main__":
    main()
