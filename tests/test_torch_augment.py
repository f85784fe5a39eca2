"""The port's paired video + box augmentation (data/augment.py, numpy, no
OpenCV) against the JAX package's cv2-backed one, and the box raster and
normalize of ops/video.py.

- The same numpy seed draws the same parameters: `PairedVideoAugment`
  gives bit-identical boxes (empty rows kept all-zero) and leaves both
  generators in the same state.
- Frames, at tests/test_augment_parity.py's tolerances: the affine warp
  (nearest) differs from cv2.warpAffine in under 2% of the pixels, the
  perspective warp (bilinear) by under 0.05 from cv2.warpPerspective; the
  homography is within 1e-8 of cv2.getPerspectiveTransform.
- `rasterize_boxes_np` and the torch `rasterize_boxes` equal JAX's;
  `normalize` within 1e-6.
- The port's augment and clip loader run with cv2 made unimportable.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.data import augment as jaug
from multimodalaggressionrecognition_tpu.ops import video as jvideo
from multimodalaggressionrecognition_tpu_torch.data import augment as aug
from multimodalaggressionrecognition_tpu_torch.ops import video


@pytest.fixture
def cv2():
    """The JAX side warps with OpenCV: without it it skips the affine warp,
    and there is nothing to compare."""
    return pytest.importorskip("cv2")


def _clip(seed, t=3, h=36, w=44, c=3):
    rng = np.random.default_rng(seed)
    video = rng.uniform(0, 1, (t, h, w, c)).astype(np.float32)
    boxes = np.tile(np.asarray([[3.3, 4.7, 20.1, 30.9]], np.float32), (t, 1))
    boxes[1] = 0.0  # an empty box stays empty
    return video, boxes


# (frames, H, W, C): the test file's canvas, the entries' 112 px, a
# non-square odd one and a 1-channel clip
CLIPS = [(3, 36, 44, 3), (2, 112, 112, 3), (3, 17, 23, 3), (2, 32, 32, 1)]


@pytest.mark.parametrize("t,h,w,c", CLIPS)
@pytest.mark.parametrize("seed", range(4))
def test_paired_augment_matches_jax(cv2, t, h, w, c, seed):
    video, boxes = _clip(seed + h, t, h, w, c)
    want_aug, got_aug = jaug.PairedVideoAugment(seed=seed), \
        aug.PairedVideoAugment(seed=seed)
    for _ in range(3):  # successive clips draw on from the same generator
        want_v, want_b = want_aug(video, boxes)
        got_v, got_b = got_aug(video, boxes)
        assert got_b.dtype == want_b.dtype
        np.testing.assert_array_equal(got_b, want_b)
        assert not got_b[1].any()
        assert got_v.shape == want_v.shape == video.shape
        assert got_v.dtype == np.float32
        assert np.abs(got_v - want_v).max() < 0.05
    assert got_aug.rng.random() == want_aug.rng.random()


class _FixedRng:
    """Tie-free affine parameters, as tests/test_augment_parity.py's."""

    def __init__(self):
        self._vals = iter([0.31, -0.27, 0.18, 0.93, 0.41, -0.22])

    def uniform(self, lo, hi):
        return lo + (hi - lo) * (next(self._vals) * 0.5 + 0.5)


@pytest.mark.parametrize("h,w", [(36, 44), (112, 112)])
def test_affine_frames_match_cv2(cv2, h, w):
    video, boxes = _clip(1, 2, h, w)
    kw = dict(degrees=17.0, translate=(0.1, 0.1), scale=(0.8, 1.2),
              shear=(-8.0, 8.0, -8.0, 8.0))
    want_v, want_b = jaug.affine_video_boxes(video, boxes, _FixedRng(), **kw)
    got_v, got_b = aug.affine_video_boxes(video, boxes, _FixedRng(), **kw)
    np.testing.assert_array_equal(got_b, want_b)
    for i in range(2):
        mismatch = np.mean(np.any(got_v[i] != want_v[i], axis=-1))
        assert mismatch < 0.02, f"frame {i}: {mismatch:.4f} pixels differ"


class _NoSkip:
    def __init__(self, seed):
        self.inner = np.random.default_rng(seed)

    def random(self):
        return 0.0  # always apply

    def integers(self, lo, hi):
        return self.inner.integers(lo, hi)


@pytest.mark.parametrize("h,w", [(36, 44), (112, 112)])
@pytest.mark.parametrize("seed", [3, 4])
def test_perspective_frames_and_homography_match_cv2(cv2, h, w, seed):
    video, boxes = _clip(seed, 2, h, w)
    start, end = aug.sample_perspective_endpoints(
        np.random.default_rng(seed), 0.5, w, h)
    np.testing.assert_allclose(
        aug.perspective_transform(start, end),
        cv2.getPerspectiveTransform(np.float32(start), np.float32(end)),
        atol=1e-8)
    want_v, want_b = jaug.perspective_video_boxes(video, boxes, _NoSkip(seed),
                                                  distortion=0.5)
    got_v, got_b = aug.perspective_video_boxes(video, boxes, _NoSkip(seed),
                                               distortion=0.5)
    np.testing.assert_array_equal(got_b, want_b)
    assert np.abs(got_v - want_v).max() < 0.05


def test_rasterize_boxes_match_jax():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(-3, 40, (6, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] * 0.5
    boxes[2] = 0.0
    boxes[3] = [4.0, 5.0, 4.0, 5.0]  # one inclusive pixel
    want = jaug.rasterize_boxes_np(boxes, 32, 40)
    np.testing.assert_array_equal(aug.rasterize_boxes_np(boxes, 32, 40),
                                  want)
    np.testing.assert_array_equal(
        video.rasterize_boxes(torch.from_numpy(boxes), 32, 40).numpy(),
        np.asarray(jvideo.rasterize_boxes(jnp.asarray(boxes), 32, 40)))
    assert want[3].sum() == 1.0 and not want[2, 1:, 1:].any()


def test_normalize_matches_jax():
    x = np.random.default_rng(6).uniform(0, 1, (2, 4, 5, 3)).astype(
        np.float32)
    mean, std = (0.43216, 0.394666, 0.37645), (0.22803, 0.22145, 0.216989)
    np.testing.assert_allclose(
        video.normalize(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jvideo.normalize(jnp.asarray(x), mean, std)), atol=1e-6)


def test_augment_and_clip_loader_need_no_cv2(tmp_path):
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        make_synthetic_clips)

    make_synthetic_clips(str(tmp_path), n_train=1, n_test=0, frames=4, hw=48)
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from multimodalaggressionrecognition_tpu_torch.data import "
        "augment, video_clips\n"
        "src = video_clips.ClipDirSource(sys.argv[1], frame_num=6, size=32,"
        " augment=augment.PairedVideoAugment(seed=0, perspective_p=1.0))\n"
        "v, m, y = src.load(0)\n"
        "assert v.shape == (6, 32, 32, 3) and m.shape == (6, 32, 32, 1)\n"
        "assert np.isfinite(v).all() and m[:4].any() and y == 0\n"
        "assert 'cv2' not in {k for k, v in sys.modules.items() if v}\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "train")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
