"""Multimodal PhysVerb training (the JAX package's cli/train_multimodal.py).

Pipeline: time-intervals table + cluster split -> aggr-type-homogeneous
batches with the EMPTY protocol -> PhysVerbModel (CNN1D audio tower +
Linear 512->hidden, or with --audio_extractor xlsr_300m XLS-R 300M +
Linear 1024->hidden; the identity over precomputed RuBERT token embeddings
as the text tower, or with --text_extractor gigachat3_1 GigaChat3.1's
decoder over transcript token ids + Linear 7168->hidden; optional windowed
Swin3D-T video tower, frozen or fine-tuned) -> fusion transformer ->
PhysVerb concat heads, with focal loss ('phys', inverse-frequency alpha) +
CE ('verb'), Adam (or the optimizer chain of cli/common.make_optimizer)
and best-UAR checkpoints, in f32 or with --compute_dtype bfloat16 (the JAX
package's tuned fine-tune: --video_remat false --compute_dtype bfloat16).
Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_multimodal \
      --dataset_root data/avabos --modalities audio,text,video \
      --video_freeze false --synthetic

XLS-R 300M (models/wav2vec.py `XLSR_300M`) is fine-tuned as it is
published for fine-tuning: its conv feature encoder frozen (no gradient,
no optimizer state), time masking and dropout on, on 10 s clips:

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_multimodal \
      --modalities audio,text --audio_extractor xlsr_300m \
      --compute_dtype bfloat16 --audio_samples 160000 --synthetic

GigaChat3.1-702B-A36B's decoder (models/gigachat.py `GIGACHAT3_1_EP32`) is
the text tower over transcript token ids (`verbal/gigachat3_1_ids/*.npy`,
int64, padded to --text_tokens; the batch carries their lengths), cut to one
expert-parallel chip's share: 1 dense and 4 MoE layers, experts 0-7 of each
layer's 256 (the router over all 256), the whole vocabulary.  Its token
embedding is frozen and its correction bias is a buffer: neither takes a
gradient or optimizer state.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_multimodal \
      --modalities audio,text --text_extractor gigachat3_1 \
      --compute_dtype bfloat16 --text_tokens 256 --learning_rate 1e-5 \
      --synthetic
"""

from dataclasses import dataclass

import numpy as np

from .common import (TrainConfig, build_trainer, compute_dtype,
                     ensure_dataset, parse_config, run_training)

SWIN_WIDTH = 768  # Swin3D-T's final width: the video tokens' width
AUDIO_EXTRACTORS = ("cnn1d", "xlsr_300m")
TEXT_EXTRACTORS = ("identity", "gigachat3_1")


@dataclass
class MultimodalConfig(TrainConfig):
    model_name: str = "multimodal_physverb"
    modalities: str = "audio,text"       # comma-separated; +video to enable
    # the audio tower: "cnn1d", or "xlsr_300m" (XLS-R 300M, its conv
    # encoder frozen)
    audio_extractor: str = "cnn1d"
    # the text tower: "identity" (precomputed 768-wide token embeddings),
    # or "gigachat3_1" (GigaChat3.1's decoder, one expert-parallel share,
    # over token ids)
    text_extractor: str = "identity"
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
    # nothing) or "dots" (save the Linear products' outputs)
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


def build_model(cfg, modalities, audio_config=None, text_config=None):
    """The PhysVerbModel for `modalities` (a subset of audio, text, video),
    on the CPU with torch's default initialization; the caller loads
    weights.  `audio_config` (a `FineTuneConfig`) replaces the XLS-R
    tower's published geometry, `text_config` (a `GigaChatConfig`) the
    GigaChat share's (tests' small sizes); a `cfg` without
    `audio_extractor` or `text_extractor` (the JAX package's configs) takes
    the CNN1D and the identity."""
    from ..models.cnn1d import AudioCnn1DExtractorWrapper
    from ..models.fusion import EqualSizedTransformerModalitiesFusion
    from ..models.physverb import (IdentityExtractor,
                                   PhysVerbClassifierConcatFeatures,
                                   PhysVerbModel)
    from ..models.wav2vec import XLSR_300M, Wav2Vec2ExtractorWrapper

    unknown = sorted(set(modalities) - {"audio", "text", "video"})
    if unknown:
        raise SystemExit(f"unknown modalities {unknown}: the model takes "
                         "audio, text and video")
    audio = getattr(cfg, "audio_extractor", "cnn1d")
    if audio not in AUDIO_EXTRACTORS:
        raise SystemExit(f"--audio_extractor must be one of "
                         f"{AUDIO_EXTRACTORS}, got {audio!r}")
    text = text_extractor(cfg)
    extractors = {}
    adaptor_sizes = {}
    feature_shapes = {}
    if "audio" in modalities:
        if audio == "cnn1d":
            extractors["audio"] = AudioCnn1DExtractorWrapper(cfg.hidden_size)
            tokens = audio_tokens(cfg.audio_samples)
        else:
            xlsr = audio_config or XLSR_300M
            extractors["audio"] = Wav2Vec2ExtractorWrapper(xlsr,
                                                           cfg.hidden_size)
            tokens = xlsr.frames(cfg.audio_samples)
        adaptor_sizes["audio"] = (cfg.hidden_size, cfg.adaptor_out)
        feature_shapes["audio"] = (tokens, cfg.hidden_size)
    if "text" in modalities:
        if text == "identity":
            extractors["text"] = IdentityExtractor()
        else:
            from ..models.gigachat import (GIGACHAT3_1_EP32,
                                           GigaChatTextExtractor)

            extractors["text"] = GigaChatTextExtractor(
                text_config or GIGACHAT3_1_EP32, cfg.hidden_size)
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


def text_extractor(cfg) -> str:
    """--text_extractor, checked; "identity" for a config without it."""
    text = getattr(cfg, "text_extractor", "identity")
    if text not in TEXT_EXTRACTORS:
        raise SystemExit(f"--text_extractor must be one of "
                         f"{TEXT_EXTRACTORS}, got {text!r}")
    return text


def make_loaders(cfg, df, split, modalities):
    from ..data.avabos import MultimodalSource, split_by_clusters
    from ..data.pipeline import BatchLoader
    from ..data.sampler import AggrBatchSampler
    from ..data.synthetic import TOKEN_IDS_TYPE
    from ..data.transforms import pad_audio, pad_ids, pad_text, pad_video

    ids = text_extractor(cfg) != "identity"
    transforms = {"text": (pad_ids if ids else pad_text)(cfg.text_tokens),
                  "audio": pad_audio(cfg.audio_samples),
                  "video": pad_video(cfg.video_frames)}
    loaders = []
    for clusters, shuffle in ((split["train"], True), (split["test"], False)):
        d = split_by_clusters(df, clusters)
        src = MultimodalSource(d, cfg.dataset_root, modalities,
                               transforms=transforms,
                               text_ids=TOKEN_IDS_TYPE if ids else None)
        sampler = AggrBatchSampler(d["aggr_type"].to_numpy(), cfg.batch_size,
                                   shuffle=shuffle, seed=cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def make_trainer(cfg):
    """The Trainer `main` runs for `cfg`: data set, loaders, the seeded
    model, the losses and every knob of the config."""
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    resolve_device(cfg.device)  # fail before any data or model work
    compute_dtype(cfg)
    modalities = tuple(cfg.modalities.split(","))
    synth = {}
    if text_extractor(cfg) != "identity":
        from ..models.gigachat import GIGACHAT3_1_EP32

        synth["token_vocab"] = GIGACHAT3_1_EP32.vocab_size
    df, split = ensure_dataset(cfg, **synth)
    train_loader, test_loader = make_loaders(cfg, df, split, modalities)
    model = seeded_init_(build_model(cfg, modalities), cfg.seed)
    loss_specs = {
        "phys": LossSpec("focal",
                         class_weights=class_weights_from_df(
                             df, "phys_aggr_label"),
                         gamma=cfg.focal_gamma),
        "verb": LossSpec("ce"),
    }
    return build_trainer(cfg, model, loss_specs, train_loader, test_loader)


def main(argv=None):
    cfg = parse_config(MultimodalConfig, argv)
    return run_training(cfg, make_trainer(cfg))


if __name__ == "__main__":
    main()
