"""Offline data preparation (the JAX package's cli/prepare_data.py: the
reference's prepare_numpy_data.py / make_pt_video.py / split_dataset.py).

Subcommands:
  decode-videos   .mp4 clips -> .npy frame tensors (uint8 THWC), optional
                  frame-range cut (the reference's frame_cut_idx=304 trick)
  resize-videos   .mp4/.npy -> resized float .pt videos (torch layout TCHW)
  resample-audio  .wav -> 16 kHz mono .pt waveforms (1, L)
  split           copy artifacts into train/ + test/ trees by the cluster
                  split JSON (reference split_dataset.py:34-79), or directly
                  by --combinations_csv/--partition_idx
  make-split      select one row of !combinations_info_table.csv by
                  partition index and emit the cluster split JSON
                  (reference split_dataset.py:17-28)

.mp4 decoding needs OpenCV (imported on first use); .npy inputs need none.
Resizing is the plain bilinear resize of the training pipeline
(data/video_clips.resize_frames: cv2.resize's INTER_LINEAR without
antialias).  resample-audio decodes with the native C++ loader
(data/native.py) wherever it builds, else with scipy and numpy.
"""

import argparse
import json
import os
import shutil

import numpy as np


def decode_videos(src: str, dst: str, frame_cut: int = 304):
    from ..data.video_clips import read_video_cv2

    os.makedirs(dst, exist_ok=True)
    for fname in sorted(os.listdir(src)):
        if not fname.endswith(".mp4"):
            continue
        video = read_video_cv2(os.path.join(src, fname))
        video = (video[:frame_cut] * 255).astype(np.uint8)
        np.save(os.path.join(dst, fname.replace(".mp4", ".npy")), video)
        print(f"decoded {fname}: {video.shape}")


def resize_videos(src: str, dst: str, size: int = 128):
    import torch

    from ..data.video_clips import read_video_cv2, resize_frames

    os.makedirs(dst, exist_ok=True)
    for fname in sorted(os.listdir(src)):
        stem, ext = os.path.splitext(fname)
        if ext == ".mp4":
            video = read_video_cv2(os.path.join(src, fname))
        elif ext == ".npy":
            video = np.load(os.path.join(src, fname)).astype(np.float32)
            if video.max() > 2.0:
                video = video / 255.0
        else:
            continue
        resized = resize_frames(video, size)
        out = torch.from_numpy(resized.transpose(0, 3, 1, 2))  # TCHW
        torch.save(out, os.path.join(dst, stem + ".pt"))
        print(f"resized {fname}: {tuple(out.shape)}")


def resample_audio(src: str, dst: str, rate: int = 16000):
    import torch

    from ..data import native
    from ..data.files import _load_wav

    os.makedirs(dst, exist_ok=True)
    for fname in sorted(os.listdir(src)):
        if not fname.endswith(".wav"):
            continue
        path = os.path.join(src, fname)
        if native.available():
            from scipy.io import wavfile

            orig_rate, data = wavfile.read(path)
            length = (int(np.ceil(rate * len(data) / orig_rate))
                      if orig_rate != rate else len(data))
            wav = native.wav_read(path, target_len=length, target_rate=rate)
        else:
            wav = _load_wav(path, rate)
        torch.save(torch.from_numpy(wav[None]),  # (1, L) like the reference
                   os.path.join(dst, fname.replace(".wav", ".pt")))
        print(f"resampled {fname}: {wav.shape}")


def make_split(combinations_csv: str, partition_idx: int,
               out_json: str = None) -> dict:
    """The frozen train/test cluster partition from the dataset's
    `!combinations_info_table.csv` (reference split_dataset.py:17-28: row
    `partition_idx` by pandas label index; `cluster__indices_combination`
    = train clusters, `rest_indices_combination` = test clusters; the
    reference parses the stringified tuples with eval, literal_eval here).

    Returns {'train': [...], 'test': [...]} and writes it to out_json when
    given: the JSON `split` and data/avabos.py load_cluster_split read.
    """
    import ast

    import pandas as pd

    table = pd.read_csv(combinations_csv)
    row = table.loc[partition_idx]

    def _clusters(cell):
        if isinstance(cell, str):
            cell = ast.literal_eval(cell)
        return [int(c) for c in cell]

    split = {"train": _clusters(row["cluster__indices_combination"]),
             "test": _clusters(row["rest_indices_combination"])}
    if out_json:
        with open(out_json, "w") as f:
            json.dump(split, f)
        print(f"wrote split (train={len(split['train'])} clusters, "
              f"test={len(split['test'])}) -> {out_json}")
    return split


def split_tree(root: str, split_json):
    """Copy verbal/physical artifacts into train/ and test/ trees keyed by
    the `c-<cluster>_...` prefix of each file name.

    `split_json` is a path to the split JSON or an already-loaded
    {name: [clusters]} dict (e.g. from make_split)."""
    if isinstance(split_json, dict):
        split = split_json
    else:
        with open(split_json) as f:
            split = json.load(f)
    cluster_to_split = {}
    for name, clusters in split.items():
        for c in clusters:
            cluster_to_split[str(c)] = name
    for sub in ("verbal", "physical"):
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, _, files in os.walk(base):
            for fname in files:
                if not fname.startswith("c-"):
                    continue
                cluster = fname[2:].split("_")[0]
                target_split = cluster_to_split.get(cluster)
                if target_split is None:
                    continue
                rel = os.path.relpath(dirpath, root)
                out_dir = os.path.join(root, target_split, rel)
                os.makedirs(out_dir, exist_ok=True)
                shutil.copy2(os.path.join(dirpath, fname),
                             os.path.join(out_dir, fname))
    print(f"split artifacts into {root}/train and {root}/test")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode-videos")
    d.add_argument("src"), d.add_argument("dst")
    d.add_argument("--frame_cut", type=int, default=304)
    r = sub.add_parser("resize-videos")
    r.add_argument("src"), r.add_argument("dst")
    r.add_argument("--size", type=int, default=128)
    a = sub.add_parser("resample-audio")
    a.add_argument("src"), a.add_argument("dst")
    a.add_argument("--rate", type=int, default=16000)
    s = sub.add_parser("split")
    s.add_argument("root"), s.add_argument("split_json", nargs="?")
    s.add_argument("--combinations_csv")
    s.add_argument("--partition_idx", type=int)
    m = sub.add_parser("make-split")
    m.add_argument("combinations_csv"), m.add_argument("out_json")
    m.add_argument("--partition_idx", type=int, required=True)
    args = p.parse_args(argv)
    if args.cmd == "decode-videos":
        decode_videos(args.src, args.dst, args.frame_cut)
    elif args.cmd == "resize-videos":
        resize_videos(args.src, args.dst, args.size)
    elif args.cmd == "resample-audio":
        resample_audio(args.src, args.dst, args.rate)
    elif args.cmd == "split":
        if args.combinations_csv is not None:
            if args.partition_idx is None:
                p.error("--combinations_csv requires --partition_idx")
            split = make_split(args.combinations_csv, args.partition_idx,
                               out_json=args.split_json)
            split_tree(args.root, split)
        elif args.split_json:
            split_tree(args.root, args.split_json)
        else:
            p.error("split needs a split_json or --combinations_csv")
    elif args.cmd == "make-split":
        make_split(args.combinations_csv, args.partition_idx,
                   out_json=args.out_json)


if __name__ == "__main__":
    main()
