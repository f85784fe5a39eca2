"""Video transformer training (the JAX package's
cli/train_video_transformer.py).

A flat directory of `*_LABEL.pt` videos ((T, C, H, W), made (T, H, W, C)
and padded or cut to `video_frames` on the host) -> on the device a
bilinear resize to `video_size` when the frames are another size -> the
frozen Swin3D-T over 8-frame windows folded into the batch (no gradient,
eval mode; its shifted blocks run the roll kernel and every block the
window-attention kernel) -> a 2-layer transformer encoder over the window
tokens -> mean-pool classifier -> CE weighted by class (0.5, 2.0) on the
single head 'main', Adam and best-UAR checkpoints.  Runs on CUDA unless
--device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_video_transformer \\
      --files_root vids --synthetic_videos
"""

import os
from dataclasses import dataclass

import numpy as np
from torch import nn

from ..models.heads import TransformerSequenceClassifier
from ..models.swin3d import Swin3dTExtractor
from ..models.video_extractors import WindowedVideoExtractor
from ..ops.video import resize_bilinear
from .common import (NamesPinConfig, build_trainer, parse_config,
                     pinned_files, run_training)


@dataclass
class VideoTransformerConfig(NamesPinConfig):
    model_name: str = "Swin3D_transformer+weighted_loss"
    files_root: str = ""
    video_frames: int = 128
    video_size: int = 112
    video_window: int = 8
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 8
    class_weight_0: float = 0.5
    class_weight_1: float = 2.0
    batch_size: int = 8
    synthetic_videos: bool = False
    synthetic_files: int = 8           # train videos in the fixture (test n/2)


class VideoTransformer(nn.Module):
    """{'video': {'data': (B, T, H, W, 3)}} -> {'main': logits (B, 2)}."""

    # flax files the Swin under the root's compact call, beside the
    # windowed extractor it is handed to (io/from_jax.py)
    jax_renames = (("backbone.", "extractor.backbone."),)

    def __init__(self, video_size: int, window: int, hidden_size: int,
                 num_layers: int, num_heads: int):
        super().__init__()
        self.video_size = video_size
        self.extractor = WindowedVideoExtractor(Swin3dTExtractor(), window,
                                                freeze=True)
        self.head = TransformerSequenceClassifier(
            class_num=2, hidden_size=hidden_size, num_layers=num_layers,
            num_heads=num_heads)

    def forward(self, modalities):
        video = modalities["video"]["data"]
        if video.shape[2] != self.video_size:
            video = resize_bilinear(video, self.video_size, self.video_size)
        return {"main": self.head(self.extractor(video))}


def make_model(cfg):
    return VideoTransformer(cfg.video_size, cfg.video_window, cfg.hidden_size,
                            cfg.num_layers, cfg.num_heads)


def make_loaders(cfg):
    from ..data.files import FilenameLabelSource, RandomBatchSampler
    from ..data.pipeline import BatchLoader
    from ..data.transforms import pad_video

    if cfg.synthetic_videos and not os.path.isdir(
            os.path.join(cfg.files_root, "train")):
        from ..data.synthetic import make_synthetic_videos

        n = cfg.synthetic_files
        make_synthetic_videos(cfg.files_root, n_train=n,
                              n_test=max(2, n // 2))
    pad = pad_video(cfg.video_frames)

    def to_thwc(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 4 and x.shape[1] in (1, 3):  # (T, C, H, W) -> (T, H, W, C)
            x = x.transpose(0, 2, 3, 1)
        return pad(x)

    loaders = []
    for sub, shuffle in (("train", True), ("test", False)):
        src = FilenameLabelSource(os.path.join(cfg.files_root, sub), "video",
                                  transform=to_thwc,
                                  files=pinned_files(cfg, sub))
        sampler = RandomBatchSampler(len(src), cfg.batch_size, shuffle,
                                     cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(VideoTransformerConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    train_loader, test_loader = make_loaders(cfg)
    spec = LossSpec("weighted_ce",
                    class_weights=(cfg.class_weight_0, cfg.class_weight_1))
    trainer = build_trainer(cfg, seeded_init_(make_model(cfg), cfg.seed),
                            {"main": spec}, train_loader, test_loader)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py)."""
    return {"video": (cfg.video_frames, cfg.video_size, cfg.video_size, 3)}


if __name__ == "__main__":
    main()
