"""Offline video feature extraction (the JAX package's
cli/extract_features.py; the reference's extract_video_features.py).

A frozen windowed video backbone (Swin3D-T, R3D-18 or S3D) runs over flat
`{train,test}/*_LABEL.{pt,npy}` clips ((T, C, H, W) or (T, H, W, C),
padded or cut to `frame_num` on the host) and saves one (T/window, D)
feature sequence per clip as `<stem>.npy` under `out_root/test/`,
`out_root/train/0/` and, with --num_epochs, `out_root/train/<epoch>/`:
the train set extracted again through a fresh paired augmentation
(data/augment.py, seeded `seed + epoch`) per epoch, as the reference did.
--train_names / --test_names pin a split's members and their order.

The backbone runs once per batch over all its windows (models/
video_extractors.py); the Swin's window attention and shifted-window roll
are the hand-written kernels, the R3D's and S3D's convs cuDNN's.  Batches
overlap with a lag-1 readback: batch N is launched, then batch N-1's
features, copied into pinned host memory behind its forward on the
stream, are waited for by their CUDA event and saved, so the host's
saving and the next batch's loading run while the card computes.
MAR_EXTRACT_PIPELINE=0 waits for each batch before the next (the JAX
package's switch).  The weights are seeded from --seed with an explicit
generator (`models/layers.seeded_init_`); pretrained weights load through
io/from_jax.py.  As in the JAX package the clips run at their own size:
--video_size is accepted and not read.  --compute_dtype bfloat16 casts
every floating weight and buffer of the backbone (BatchNorm's running
statistics included) and each batch to bf16, as the JAX CLI casts its
variables and batch; the features are saved as f32 either way.  Runs on
CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.extract_features \\
      --files_root clips --backbone swin3d_t
"""

import os
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..models.video_extractors import WindowedVideoExtractor
from .common import (NamesPinConfig, compute_dtype, parse_config,
                     pinned_files)


@dataclass
class ExtractConfig(NamesPinConfig):
    model_name: str = "extract"
    files_root: str = ""            # dir with train/ and test/ clip files
    out_root: str = ""
    backbone: str = "swin3d_t"      # swin3d_t | r3d18 | s3d
    frame_num: int = 304
    window: int = 16
    video_size: int = 112
    num_epochs: int = 0             # extra augmented train extractions
    batch_size: int = 4
    swin_gelu: str = "poly"         # the Swin's GELU: poly | erf | tanh


class Extractor(nn.Module):
    """(B, T, H, W, 3) -> (B, T // window, D); the windowed extractor is
    named `windowed` as in the JAX CLI."""

    def __init__(self, backbone: nn.Module, window: int):
        super().__init__()
        self.windowed = WindowedVideoExtractor(backbone, window=window)

    def forward(self, x):
        return self.windowed(x)


def make_backbone(cfg) -> nn.Module:
    if cfg.backbone == "swin3d_t":
        from ..models.swin3d import Swin3dTExtractor

        return Swin3dTExtractor(gelu=cfg.swin_gelu)
    if cfg.backbone == "r3d18":
        from ..models.r3d import R3D18Extractor

        return R3D18Extractor()
    if cfg.backbone == "s3d":
        from ..models.s3d import S3DExtractor

        return S3DExtractor()
    raise ValueError(f"unknown --backbone {cfg.backbone!r} "
                     "(swin3d_t | r3d18 | s3d)")


def make_extractor(cfg) -> Extractor:
    return Extractor(make_backbone(cfg), cfg.window)


def run_split(model, cfg, device, split_root, out_dir, augment=None,
              names=None, dtype=None):
    """Extract one split directory into `out_dir`, each batch cast to
    `dtype` (None: f32) on the device; returns the number of clips
    written."""
    from ..data.files import FilenameLabelSource
    from ..data.pipeline import readback
    from ..data.transforms import pad_video

    pad = pad_video(cfg.frame_num)

    def to_thwc(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 4 and x.shape[1] in (1, 3):  # (T, C, H, W)
            x = x.transpose(0, 2, 3, 1)
        return pad(x)

    src = FilenameLabelSource(split_root, "video", transform=to_thwc,
                              files=names)
    os.makedirs(out_dir, exist_ok=True)

    def save(idx, host, event):
        if event is not None:
            event.synchronize()
        feats = host.numpy()
        for j, i in enumerate(idx):
            stem = os.path.splitext(src.files[i])[0]
            np.save(os.path.join(out_dir, f"{stem}.npy"), feats[j])

    depth = 0 if os.environ.get("MAR_EXTRACT_PIPELINE") == "0" else 1
    pending = deque()
    for start in range(0, len(src), cfg.batch_size):
        idx = list(range(start, min(start + cfg.batch_size, len(src))))
        clips = []
        for i in idx:
            x, _ = src.load(i)
            if augment is not None:
                x, _ = augment(x, None)
            clips.append(x)
        batch = torch.from_numpy(np.stack(clips))
        if device.type == "cuda":
            batch = batch.pin_memory()
        with torch.inference_mode():
            x = batch.to(device, non_blocking=True)
            feats = model(x if dtype is None else x.to(dtype)).float()
        pending.append((idx, *readback(feats, device)))
        if len(pending) > depth:
            save(*pending.popleft())
    while pending:
        save(*pending.popleft())
    return len(src)


def main(argv=None):
    from ..data.augment import PairedVideoAugment
    from ..models.layers import seeded_init_
    from ..serve import resolve_device

    cfg = parse_config(ExtractConfig, argv)
    device = resolve_device(cfg.device)
    dtype = compute_dtype(cfg)
    out_root = cfg.out_root or (cfg.files_root + "_features")
    model = seeded_init_(make_extractor(cfg), cfg.seed).to(device).eval()
    if dtype is not None:
        model = model.to(dtype)
    train_root = os.path.join(cfg.files_root, "train")
    run_split(model, cfg, device, os.path.join(cfg.files_root, "test"),
              os.path.join(out_root, "test"), names=pinned_files(cfg, "test"),
              dtype=dtype)
    run_split(model, cfg, device, train_root,
              os.path.join(out_root, "train", "0"),
              names=pinned_files(cfg, "train"), dtype=dtype)
    for epoch in range(1, cfg.num_epochs + 1):
        run_split(model, cfg, device, train_root,
                  os.path.join(out_root, "train", str(epoch)),
                  augment=PairedVideoAugment(seed=cfg.seed + epoch),
                  names=pinned_files(cfg, "train"), dtype=dtype)
    print(f"features written to {out_root}")
    return out_root


if __name__ == "__main__":
    main()
