"""3-D CNN with bbox masks training (the JAX package's cli/train3dcnn.py,
the reference's train3dcnn.py).

Clip dirs (`video.pt` | `video.npy` | `video.mp4` + `bboxes.npy`, 4-class
Russian labels, or 2 with --two_class) -> on the host the paired
perspective / affine / flip augmentation (train only), a resize to
`video_size` and the box mask -> R3DWithBboxes (the mask blended in before
every stage, alpha 0.4) -> CE on the single head 'main', Adam, and best
checkpoints by accuracy; 32 frames at 112 px, batch 8.  Every conv is
cuDNN's: the path has no hand-written kernel, as the JAX package's has no
Pallas kernel.  Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train3dcnn \\
      --files_root clips --synthetic_clips
"""

import os
from dataclasses import dataclass

from torch import nn

from ..models.r3d import R3DWithBboxes
from .common import TrainConfig, build_trainer, parse_config, run_training


@dataclass
class Cnn3DConfig(TrainConfig):
    model_name: str = "r3d_bboxes"
    files_root: str = ""
    class_num: int = 4
    two_class: bool = False
    frame_num: int = 32
    video_size: int = 112
    alpha: float = 0.4
    batch_size: int = 8
    checkpoint_criterion: str = "accuracy"
    synthetic_clips: bool = False
    synthetic_files: int = 8           # train clips in the fixture (test n/2)


def num_classes(cfg) -> int:
    return 2 if cfg.two_class else cfg.class_num


class Cnn3DModel(nn.Module):
    """{'video': {'data': (B, T, H, W, 3), 'mask': (B, T, H, W, 1)}} ->
    {'main': logits}; the module is named `r3d` as the JAX adapter names
    it."""

    def __init__(self, class_num: int, alpha: float):
        super().__init__()
        self.r3d = R3DWithBboxes(class_num, alpha=alpha)

    def forward(self, modalities):
        video = modalities["video"]
        return {"main": self.r3d(video["data"], video.get("mask"))}


def make_model(cfg):
    return Cnn3DModel(num_classes(cfg), cfg.alpha)


def make_loaders(cfg):
    from ..data.augment import PairedVideoAugment
    from ..data.files import RandomBatchSampler
    from ..data.pipeline import BatchLoader
    from ..data.video_clips import LABELS_2CLASS, LABELS_4CLASS, ClipDirSource

    if cfg.synthetic_clips and not os.path.isdir(
            os.path.join(cfg.files_root, "train")):
        from ..data.synthetic import make_synthetic_clips

        n = cfg.synthetic_files
        make_synthetic_clips(cfg.files_root, n_train=n, n_test=max(2, n // 2),
                             frames=cfg.frame_num, hw=cfg.video_size)
    label_dict = LABELS_2CLASS if cfg.two_class else LABELS_4CLASS
    loaders = []
    for sub, shuffle in (("train", True), ("test", False)):
        src = ClipDirSource(
            os.path.join(cfg.files_root, sub), frame_num=cfg.frame_num,
            size=cfg.video_size, label_dict=label_dict,
            augment=PairedVideoAugment(seed=cfg.seed) if shuffle else None)
        sampler = RandomBatchSampler(len(src), cfg.batch_size, shuffle,
                                     cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(Cnn3DConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    train_loader, test_loader = make_loaders(cfg)
    trainer = build_trainer(cfg, seeded_init_(make_model(cfg), cfg.seed),
                            {"main": LossSpec("ce")}, train_loader,
                            test_loader, num_classes=num_classes(cfg))
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py).  The
    exported forward scores raw clips without bbox masks (the mask input
    is optional in R3DWithBboxes; serving requests carry none)."""
    return {"video": (cfg.frame_num, cfg.video_size, cfg.video_size, 3)}


if __name__ == "__main__":
    main()
