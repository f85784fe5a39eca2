"""Synthetic AVABOS-shaped dataset generator (test/bench fixture; a copy of
the JAX package's data/synthetic.py, which the port does not import), and
the flat wav, video and feature-sequence fixtures of the single-modality
entries and the clip directories of the 3-D CNN entry.

The real AVABOS dataset is private; every integration test and benchmark in
this framework runs on this generator, which reproduces the reference's
on-disk layout (reference datasets.py:513-562, split_dataset.py:34-91):

  root/
    verbal/<embed_type>/c-...npy        (T_text, 768) RuBERT token embeddings
    verbal/<ids_type>/c-...npy          (T,) int64 transcript token ids
                                        (with `token_vocab` only)
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
TOKEN_IDS_TYPE = "gigachat3_1_ids"  # the token ids' directory under verbal/
_LABELS = ("NOAGGR", "AGGR")


def generate_synthetic_avabos(
        root: str, num_clusters: int = 4, samples_per_cluster: int = 6,
        seed: int = 0, audio_len: int = 48000, text_len: int = 32,
        text_dim: int = 768, video_frames: int = 32, video_hw: int = 64,
        embed_type: str = "ru_conversational_cased_L-12_H-768_A-12_pt_v1_tokens",
        token_vocab: int = 0, ids_type: str = TOKEN_IDS_TYPE):
    """Writes the artifact tree; returns (intervals_df, split_dict).  With
    `token_vocab` each verbal clip also gets 4 to `text_len` token ids in
    [1, token_vocab), class-coded (AGGR ids from the vocabulary's upper
    half), drawn from a generator of their own so the rest of the tree is
    the same with or without them."""
    import torch  # the .pt artifacts

    rng = np.random.default_rng(seed)
    id_rng = np.random.default_rng([seed, 1])
    if token_vocab:
        os.makedirs(os.path.join(root, "verbal", ids_type), exist_ok=True)
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
                if token_vocab:
                    half = token_vocab // 2
                    lo = half if verb_label == "AGGR" else 1
                    n = int(id_rng.integers(4, text_len + 1))
                    ids = id_rng.integers(lo, lo + half - 1, n).astype(np.int64)
                    np.save(os.path.join(root, "verbal", ids_type,
                                         f"{name}.npy"), ids)
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


def make_synthetic_wavs(root, rate, n_train=32, n_test=8, seed=0,
                        tones=False):
    """Flat `root/{train,test}/clip{i}_{LABEL}.wav` fixture of 2 s int16
    clips, labels alternating NOAGGR/AGGR (the JAX package's
    cli/train_audio_rnn.py `_make_synthetic_wavs`, byte for byte).  Plain
    clips are noise with a class-signed offset; `tones` clips carry a
    class-coded carrier (AGGR 3 kHz, NOAGGR 440 Hz) at a random phase,
    separable in a magnitude spectrogram."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(rate * 2, dtype=np.float32) / rate
    for sub, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            label = "AGGR" if i % 2 else "NOAGGR"
            if tones:
                freq = 3000.0 if label == "AGGR" else 440.0
                phase = rng.uniform(0, 2 * np.pi)
                wav = (0.4 * np.sin(2 * np.pi * freq * t + phase)
                       + rng.standard_normal(rate * 2).astype(np.float32) * 0.05)
            else:
                shift = 0.02 if label == "AGGR" else -0.02
                wav = (rng.standard_normal(rate * 2).astype(np.float32) * 0.1
                       + shift)
            wavfile.write(os.path.join(root, sub, f"clip{i}_{label}.wav"),
                          rate, (wav * 32767).astype(np.int16))


def make_synthetic_videos(root, n_train=8, n_test=4, frames=32, hw=64,
                          seed=0):
    """Flat `root/{train,test}/clip{i}_{LABEL}.pt` fixture of (frames, 3, hw,
    hw) f32 clips, labels alternating NOAGGR/AGGR, each noise with a
    class-signed brightness (the JAX package's
    cli/train_video_transformer.py `_make_synthetic_videos`, byte for
    byte)."""
    import torch

    rng = np.random.default_rng(seed)
    for sub, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            label = "AGGR" if i % 2 else "NOAGGR"
            shift = 0.3 if label == "AGGR" else -0.3
            vid = (rng.standard_normal((frames, 3, hw, hw)).astype(np.float32)
                   * 0.2 + shift)
            torch.save(torch.from_numpy(vid),
                       os.path.join(root, sub, f"clip{i}_{label}.pt"))


def make_synthetic_features(root, dim, n_train=32, n_test=8, seq=19, seed=0):
    """`root/train/0/` and `root/test/` fixtures of (seq, dim) f32 `.npy`
    feature sequences, labels alternating NOAGGR/AGGR, each noise with a
    class-signed offset (the JAX package's cli/train_video_rnn.py
    `_make_synthetic_features`, byte for byte)."""
    rng = np.random.default_rng(seed)
    for sub, n in (("train/0", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            label = "AGGR" if i % 2 else "NOAGGR"
            shift = 0.3 if label == "AGGR" else -0.3
            feats = rng.standard_normal((seq, dim)).astype(np.float32) + shift
            np.save(os.path.join(root, sub, f"clip{i}_{label}.npy"), feats)


def make_synthetic_clips(root, n_train=8, n_test=4, frames=16, hw=64, seed=0):
    """`root/{train,test}/clip!person,{i}!(0,1)!{LABEL}/` clip dirs, each
    with `video.pt` ((frames, 3, hw, hw) f32 noise brightened by 0.1 per
    class id) and `bboxes.npy` (the box [8, 8, 40, 40] on every frame),
    labels cycling through the four classes (the JAX package's
    cli/train3dcnn.py `_make_synthetic_clips`, byte for byte)."""
    import torch

    labels = ["Нет", "Захваты", "Толчки", "Удары"]
    rng = np.random.default_rng(seed)
    for sub, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            label = labels[i % len(labels)]
            d = os.path.join(root, sub, f"clip!person,{i}!(0,1)!{label}")
            os.makedirs(d, exist_ok=True)
            vid = rng.uniform(0, 1, (frames, 3, hw, hw)).astype(np.float32)
            vid += 0.1 * (labels.index(label))
            torch.save(torch.from_numpy(vid), os.path.join(d, "video.pt"))
            boxes = np.tile(np.asarray([[8, 8, 40, 40]], np.float32),
                            (frames, 1))
            np.save(os.path.join(d, "bboxes.npy"), boxes)
