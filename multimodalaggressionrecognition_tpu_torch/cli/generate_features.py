"""Dump fused multimodal embeddings (the JAX package's
cli/generate_features.py; the reference's generate_features.ipynb,
`PhysVerbModelFeat` + `MultimodalFeatureGenDataset`).

The PhysVerb model of cli/train_multimodal.py runs up to its fusion output
(`extract_features`, then the fusion encoder) over every row of the
intervals table, train split then test split in the trainer's batches,
and saves one `.npy` per sample, `<split>_<count:06d>.npy`: a pickled dict
{modality: (T_m, hidden) fused token sequence}; `manifest.csv` lists each
file's name, split, labels and label masks.  The weights come from
--path_to_checkpoint (any port checkpoint: `checkpoint_best_*` or
`checkpoint_current`), else from --seed.  On the tri-modal model a batch
with video runs the window attention and roll kernels, one with audio the
framed conv.  A lag-1 readback, as in cli/extract_features.py: batch N is
launched, then batch N-1's tokens, copied into pinned host memory behind
its forward, are waited for and saved.  Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.generate_features \\
      --dataset_root data/avabos --modalities audio,text,video \\
      --path_to_checkpoint runs/<run>/checkpoint_best_phys
"""

import os
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .common import ensure_dataset, parse_config, require_float32
from .train_multimodal import MultimodalConfig, build_model, make_loaders


@dataclass
class GenFeaturesConfig(MultimodalConfig):
    path_to_checkpoint: str = ""
    out_dir: str = "fused_features"


def fused_features(model, modalities):
    """{modality: (B, T_m, hidden)}: the PhysVerb model's tokens after its
    fusion (or its extractors', without one)."""
    feats = model.extract_features(modalities)
    return model.fusion(feats) if model.fusion is not None else feats


def main(argv=None):
    import pandas as pd

    from ..data.pipeline import device_prefetch, readback
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import resolve_device

    cfg = parse_config(GenFeaturesConfig, argv)
    device = resolve_device(cfg.device)  # fail before any data or model work
    require_float32(cfg, "generate_features")
    modalities = tuple(cfg.modalities.split(","))
    df, split = ensure_dataset(cfg)
    train_loader, test_loader = make_loaders(cfg, df, split, modalities)
    model = seeded_init_(build_model(cfg, modalities), cfg.seed)
    if cfg.path_to_checkpoint:
        state_dict, _ = restore_variables(cfg.path_to_checkpoint)
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    os.makedirs(cfg.out_dir, exist_ok=True)
    manifest = []

    def save(split_name, host, event):
        if event is not None:
            event.synchronize()
        feats = {k: v.numpy() for k, v in host["feats"].items()}
        for i in range(int(host["sample_mask"].sum())):  # padding rows last
            name = f"{split_name}_{len(manifest):06d}"
            np.save(os.path.join(cfg.out_dir, f"{name}.npy"),
                    {k: v[i] for k, v in feats.items()}, allow_pickle=True)
            row = {"name": name, "split": split_name}
            for head in ("phys", "verb"):
                if head in host["labels"]:
                    row[head] = int(host["labels"][head][i])
                    row[f"{head}_mask"] = float(host["label_mask"][head][i])
            manifest.append(row)

    pending = deque()
    for loader, split_name in ((train_loader, "train"), (test_loader, "test")):
        for batch in device_prefetch(iter(loader), device):
            with torch.inference_mode():
                feats = fused_features(model, batch["modalities"])
            out = {"feats": feats, "labels": batch["labels"],
                   "label_mask": batch["label_mask"],
                   "sample_mask": batch["sample_mask"]}
            pending.append((split_name, *readback(out, device)))
            if len(pending) > 1:
                save(*pending.popleft())
    while pending:
        save(*pending.popleft())
    pd.DataFrame(manifest).to_csv(os.path.join(cfg.out_dir, "manifest.csv"),
                                  index=False)
    print(f"wrote {len(manifest)} fused feature files to {cfg.out_dir}")
    return cfg.out_dir


if __name__ == "__main__":
    main()
