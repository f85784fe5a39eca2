"""The port's clip-directory dataset (data/video_clips.py) and its
synthetic fixture against the JAX package's.

- `make_synthetic_clips` writes the JAX fixture's files byte for byte.
- `ClipDirSource` without augmentation gives JAX's batches, frames and
  masks, with 4-class and 2-class labels: bit for bit where no resize
  runs; where the clips need one (48 -> 32 px), the port's bilinear
  matrices against cv2.resize(INTER_LINEAR) within 1e-5, and the masks of
  the scaled boxes bit for bit.
- A `video.npy` clip loads as its `video.pt` twin; a `video.mp4` clip
  with neither the native decoder nor OpenCV raises naming the remedy.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train3dcnn as jcli
from multimodalaggressionrecognition_tpu.data import video_clips as jclips
from multimodalaggressionrecognition_tpu_torch.data import native, video_clips
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_clips)
from test_torch_files import _assert_same_batches


def test_synthetic_clips_are_byte_equal_to_jax(tmp_path):
    kw = dict(n_train=5, n_test=2, frames=3, hw=8, seed=4)
    jcli._make_synthetic_clips(str(tmp_path / "jax"), **kw)
    make_synthetic_clips(str(tmp_path / "port"), **kw)
    for sub in ("train", "test"):
        dirs = sorted(os.listdir(tmp_path / "jax" / sub))
        assert dirs == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(dirs) == kw[f"n_{sub}"]
        for d in dirs:
            for f in ("video.pt", "bboxes.npy"):
                assert ((tmp_path / "port" / sub / d / f).read_bytes()
                        == (tmp_path / "jax" / sub / d / f).read_bytes()), d


class _Loader:
    """ClipDirSource batches of fixed index lists, as a loader."""

    def __init__(self, src, batches, pad_to):
        self.src, self.batches, self.pad_to = src, batches, pad_to

    def __iter__(self):
        return (self.src.build_batch(b, pad_to=self.pad_to)
                for b in self.batches)


@pytest.mark.parametrize("two_class", [False, True])
@pytest.mark.parametrize("hw", [32, 48])
def test_clip_dir_batches_match_jax(tmp_path, two_class, hw):
    root = str(tmp_path / "train")
    make_synthetic_clips(str(tmp_path), n_train=6, n_test=0, frames=5, hw=hw)
    labels = ((jclips.LABELS_2CLASS, video_clips.LABELS_2CLASS) if two_class
              else (jclips.LABELS_4CLASS, video_clips.LABELS_4CLASS))
    assert labels[0] == labels[1]
    kw = dict(frame_num=7, size=32)
    want_src = jclips.ClipDirSource(root, label_dict=labels[0], **kw)
    got_src = video_clips.ClipDirSource(root, label_dict=labels[1], **kw)
    np.testing.assert_array_equal(got_src.labels(), want_src.labels())
    assert sorted(set(got_src.labels())) == ([0, 1] if two_class
                                             else [0, 1, 2, 3])
    batches = [[0, 1, 2, 3], [5, 4]]
    if hw == 32:  # no resize: bit for bit, padding rows included
        _assert_same_batches(_Loader(got_src, batches, 4),
                             _Loader(want_src, batches, 4), epochs=1)
        return
    for idx in batches:
        got, want = (s.build_batch(idx, pad_to=4) for s in (got_src,
                                                            want_src))
        gv, wv = got["modalities"]["video"], want["modalities"]["video"]
        assert gv["data"].shape == wv["data"].shape == (4, 7, 32, 32, 3)
        np.testing.assert_allclose(gv["data"], wv["data"], atol=1e-5)
        np.testing.assert_array_equal(gv["mask"], wv["mask"])
        for key in ("labels", "label_mask"):
            np.testing.assert_array_equal(got[key]["main"], want[key]["main"])
        np.testing.assert_array_equal(got["sample_mask"], want["sample_mask"])


def test_npy_clip_loads_as_its_pt_twin_and_mp4_needs_opencv(tmp_path,
                                                           monkeypatch):
    make_synthetic_clips(str(tmp_path), n_train=2, n_test=0, frames=4, hw=16)
    root = tmp_path / "train"
    clips = sorted(os.listdir(root))
    frames = torch.load(root / clips[1] / "video.pt").numpy()
    shutil.rmtree(root / clips[1])
    shutil.copytree(root / clips[0], root / clips[1])
    os.remove(root / clips[1] / "video.pt")
    np.save(root / clips[1] / "video.npy",
            torch.load(root / clips[0] / "video.pt").numpy())
    src = video_clips.ClipDirSource(str(root), frame_num=4, size=16)
    a, b = src.load(0), src.load(1)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].shape == (4, 16, 16, 3) and frames.shape == (4, 3, 16, 16)

    (root / clips[0] / "video.mp4").write_bytes(b"")
    monkeypatch.setattr(native, "video_available", lambda: False)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="video.pt or video.npy"):
        src.load(0)
