"""Synthetic AVABOS-shaped dataset generator (test/bench fixture; a copy of
the JAX package's data/synthetic.py, which the port does not import).

The real AVABOS dataset is private; every integration test and benchmark in
this framework runs on this generator, which reproduces the reference's
on-disk layout (reference datasets.py:513-562, split_dataset.py:34-91):

  root/
    verbal/<embed_type>/c-...npy        (T_text, 768) RuBERT token embeddings
    verbal/pt_waveform/c-...pt          (1, L) 16 kHz waveform
    physical/video/c-...pt              (T, C, H, W) uint8-ish frames
    time_intervals.csv
    train_test_split.json               {'train': [...], 'test': [...]}
"""

import json
import os

import numpy as np
import pandas as pd

_AGGR_TYPES = ("verb", "phys", "phys&verb")
_LABELS = ("NOAGGR", "AGGR")


def generate_synthetic_avabos(
        root: str, num_clusters: int = 4, samples_per_cluster: int = 6,
        seed: int = 0, audio_len: int = 48000, text_len: int = 32,
        text_dim: int = 768, video_frames: int = 32, video_hw: int = 64,
        embed_type: str = "ru_conversational_cased_L-12_H-768_A-12_pt_v1_tokens"):
    """Writes the artifact tree; returns (intervals_df, split_dict)."""
    import torch  # the .pt artifacts

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "verbal", embed_type), exist_ok=True)
    os.makedirs(os.path.join(root, "verbal", "pt_waveform"), exist_ok=True)
    os.makedirs(os.path.join(root, "physical", "video"), exist_ok=True)

    rows = []
    for cluster in range(num_clusters):
        for i in range(samples_per_cluster):
            aggr_type = _AGGR_TYPES[int(rng.integers(len(_AGGR_TYPES)))]
            phys_label = _LABELS[int(rng.integers(2))]
            verb_label = _LABELS[int(rng.integers(2))]
            t1 = int(rng.integers(0, 50000))
            row = {
                "aggr_type": aggr_type,
                "cluster_id": cluster,
                "video_id": f"vid{cluster}{i}",
                "person_id": i % 3,
                "phys_t1": t1, "phys_t2": t1 + 3000,
                "verb_t1": t1 + 100, "verb_t2": t1 + 4100,
                "phys_aggr_label": phys_label,
                "verb_aggr_label": verb_label,
            }
            rows.append(row)
            # artifacts for the present modalities
            from .avabos import AGGR_PRESENCE, clip_name

            present = AGGR_PRESENCE[aggr_type]
            # class-correlated means so training can actually learn
            if "text" in present or "audio" in present:
                verb_shift = 0.5 if verb_label == "AGGR" else -0.5
                name = clip_name(row, "verb")
                text = rng.standard_normal((text_len, text_dim)).astype(np.float32) + verb_shift
                np.save(os.path.join(root, "verbal", embed_type, f"{name}.npy"), text)
                wav = (rng.standard_normal((1, audio_len)).astype(np.float32) * 0.1
                       + verb_shift * 0.05)
                torch.save(torch.from_numpy(wav),
                           os.path.join(root, "verbal", "pt_waveform", f"{name}.pt"))
            if "video" in present:
                phys_shift = 0.3 if phys_label == "AGGR" else -0.3
                name = clip_name(row, "phys")
                video = (rng.standard_normal(
                    (video_frames, 3, video_hw, video_hw)).astype(np.float32) * 0.2
                    + phys_shift)
                torch.save(torch.from_numpy(video),
                           os.path.join(root, "physical", "video", f"{name}.pt"))

    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(root, "time_intervals.csv"), index=False)
    clusters = list(range(num_clusters))
    split = {"train": clusters[: max(1, num_clusters - 1)],
             "test": clusters[max(1, num_clusters - 1):]}
    with open(os.path.join(root, "train_test_split.json"), "w") as f:
        json.dump(split, f)
    return df, split
