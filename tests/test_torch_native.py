"""The port's native host loaders (data/native.py, built from native/*.cpp
into the package's _build/) against the JAX package's data/native.py and
the numpy paths, at tests/test_native.py's and tests/test_native_video.py's
tolerances.

- WAVs: `wav_read` within 2e-3 after a 44.1 kHz resample (`:40`) and 1e-6
  where the data is exact (float32 at the target rate); `wav_batch` on 1
  and 3 threads equal to `wav_read` file by file; `resample` within 1e-4.
- Video: `video_probe`, `video_read` (`max_frames`, `size`) and
  `video_batch` (zero padding, IOError on a missing file) equal to JAX's
  (the same libswscale in one process), cv2 within 2 levels at the 99th
  percentile and under 1 on average (`tests/test_native_video.py:74-75`);
  `read_video(start=, end=)` without touching cv2; `ClipDirSource` over an
  .mp4 clip dir equal to JAX's.  These skip only where cv2 or pkg-config's
  libav* libraries are missing.
- `prepare_data resample-audio` with both packages' native loaders on.
- The build writes only under _build/ (native/*.so keep their bytes), and a
  library that cannot be built says why.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from multimodalaggressionrecognition_tpu.cli import prepare_data as jprep
from multimodalaggressionrecognition_tpu.data import native as jnative
from multimodalaggressionrecognition_tpu.data import video_clips as jclips
from multimodalaggressionrecognition_tpu.ops.resample import resample_poly_np
from multimodalaggressionrecognition_tpu_torch.cli import prepare_data
from multimodalaggressionrecognition_tpu_torch.data import native, video_clips

NATIVE_DIR = native.NATIVE_DIR


def _write_wav(path, rate, data, dtype=np.int16):
    if dtype == np.int16:
        wavfile.write(path, rate, (data * 32767).astype(np.int16))
    else:
        wavfile.write(path, rate, data.astype(np.float32))
    return path


def _digests():
    return {f: hashlib.sha256(open(os.path.join(NATIVE_DIR, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(NATIVE_DIR))}


@pytest.fixture(scope="module", autouse=True)
def native_dir_untouched():
    """Nothing this file runs writes under native/."""
    before = _digests()
    yield
    assert _digests() == before


def test_wav_read_matches_jax_and_numpy(tmp_path):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal(44100) * 0.3).astype(np.float32)
    path = _write_wav(str(tmp_path / "a.wav"), 44100, data)
    got = native.wav_read(path, target_len=16000, target_rate=16000)
    assert got.dtype == np.float32 and got.shape == (16000,)
    q = (data * 32767).astype(np.int16) / 32768.0
    ref = resample_poly_np(q.astype(np.float32), 44100, 16000)
    n = min(len(ref), 16000)
    np.testing.assert_allclose(got[:n], ref[:n], atol=2e-3)
    assert np.all(got[n:] == 0)
    want = jnative.wav_read(path, target_len=16000, target_rate=16000)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_wav_read_float32_is_exact(tmp_path):
    rng = np.random.default_rng(1)
    data = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    path = _write_wav(str(tmp_path / "f.wav"), 16000, data, np.float32)
    got = native.wav_read(path, target_len=8000, target_rate=16000)
    np.testing.assert_allclose(got, data, atol=1e-6)
    np.testing.assert_allclose(
        got, jnative.wav_read(path, target_len=8000, target_rate=16000),
        atol=1e-6)


@pytest.mark.parametrize("threads", [1, 3])
def test_wav_batch_equals_wav_read(tmp_path, threads):
    rng = np.random.default_rng(2)
    paths = []
    for i, rate in enumerate((16000, 44100, 22050, 16000, 44100, 8000)):
        data = (rng.standard_normal(rate // 2) * 0.2).astype(np.float32)
        paths.append(_write_wav(str(tmp_path / f"b{i}.wav"), rate, data,
                                np.float32 if i % 2 else np.int16))
    batch = native.wav_batch(paths, target_len=8000, target_rate=16000,
                             num_threads=threads)
    assert batch.shape == (6, 8000) and batch.dtype == np.float32
    for row, path in zip(batch, paths):
        np.testing.assert_array_equal(
            row, native.wav_read(path, target_len=8000, target_rate=16000))
    np.testing.assert_allclose(
        batch, jnative.wav_batch(paths, target_len=8000, target_rate=16000,
                                 num_threads=threads), atol=2e-3)
    with pytest.raises(IOError, match="1 wav files failed"):
        native.wav_batch(paths[:1] + [str(tmp_path / "missing.wav")], 8000)


def test_resample_matches_jax_and_numpy():
    x = (np.random.default_rng(3).standard_normal(4000) * 0.5).astype(
        np.float32)
    got = native.resample(x, 44100, 16000)
    ref = resample_poly_np(x, 44100, 16000)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, jnative.resample(x, 44100, 16000),
                               atol=1e-4)


def test_prepare_data_resample_audio_matches_the_jax_cli(tmp_path):
    """Both CLIs decode with their native loaders (the JAX one whenever its
    library loads, the port's wherever it builds)."""
    assert jnative.available() and native.available()
    rng = np.random.default_rng(4)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, rate in enumerate((44100, 16000, 22050)):
        wavfile.write(str(wavs / f"c{i}_AGGR.wav"), rate,
                      (rng.standard_normal(rate) * 0.1 * 32767).astype(
                          np.int16))
    jprep.main(["resample-audio", str(wavs), str(tmp_path / "jax")])
    prepare_data.main(["resample-audio", str(wavs), str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 3
    for name in names:
        got, want = (torch.load(tmp_path / d / name, weights_only=True)
                     for d in ("port", "jax"))
        assert got.shape == want.shape == (1, 16000)
        assert got.dtype == want.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6
                                   if name == "c1_AGGR.pt" else 2e-3)


def test_build_writes_only_under_the_build_dir(tmp_path, monkeypatch):
    """A fresh build lands in the build directory under a name keyed by
    the source, the flags and the compiler, published whole (no temporary
    file is left); native/ keeps its bytes (the module fixture)."""
    before = _digests()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_reasons", {})
    assert native.available()
    built = os.listdir(tmp_path / "_build")
    assert len(built) == 1 and built[0].startswith("libmarhost-")
    assert built[0].endswith(".so")
    assert native.library_path("marhost") == str(tmp_path / "_build"
                                                 / built[0])
    path = str(tmp_path / "f.wav")
    _write_wav(path, 16000, np.linspace(-0.5, 0.5, 800, dtype=np.float32),
               np.float32)
    np.testing.assert_allclose(native.wav_read(path, 800),
                               np.linspace(-0.5, 0.5, 800), atol=1e-6)
    assert _digests() == before


def test_unavailable_library_says_why(monkeypatch):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_reasons", {})
    which = shutil.which
    monkeypatch.setattr(native.shutil, "which",
                        lambda cmd: None if cmd == "g++" else which(cmd))
    assert native.available() is False
    assert native.unavailable_reasons()["libmarhost"] == "g++ not found"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.wav_read("x.wav", 10)

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", which)
    if which("pkg-config") is None:
        pytest.skip("no pkg-config here")
    monkeypatch.setattr(native, "FFMPEG_PACKAGES",
                        native.FFMPEG_PACKAGES + ("libmar-absent",))
    assert native.video_available() is False
    assert native.unavailable_reasons()["libmarvideo"] == (
        "pkg-config finds no libmar-absent")


# video: the native FFmpeg decoder against JAX's, cv2 and the clip source


@pytest.fixture(scope="module")
def cv2():
    cv2 = pytest.importorskip("cv2")
    if not native.video_available():
        pytest.skip(f"libmarvideo unavailable: "
                    f"{native.unavailable_reasons()['libmarvideo']}")
    if not jnative.video_available():
        pytest.skip("the JAX package's libmarvideo.so does not load here")
    return cv2


def _write_mp4(cv2, path, frames, fps=10.0):
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        pytest.skip("no working cv2 mp4 codec in this environment")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    if os.path.getsize(path) == 0:
        pytest.skip("cv2 produced an empty mp4")
    return path


def _frames(n, h, w, seed):
    frames = np.random.default_rng(seed).uniform(0, 255, (n, h, w, 3)).astype(
        np.uint8)
    frames[:, :h // 2] = 200  # blocks survive lossy encoding recognizably
    frames[:, h // 2:] = 40
    return frames


@pytest.fixture(scope="module")
def clip(cv2, tmp_path_factory):
    frames = _frames(12, 48, 64, 7)
    path = str(tmp_path_factory.mktemp("vid") / "video.mp4")
    return _write_mp4(cv2, path, frames), frames


def test_probe_and_read_match_jax_and_cv2(clip):
    path, frames = clip
    probe = native.video_probe(path)
    assert probe == jnative.video_probe(path)
    assert probe[:2] == (64, 48) and probe[2] in (0, len(frames))
    got = native.video_read(path)
    assert got.dtype == np.uint8 and got.shape == (12, 48, 64, 3)
    np.testing.assert_array_equal(got, jnative.video_read(path))
    ref = (video_clips.read_video_cv2(path) * 255.0).round().astype(np.int32)
    diff = np.abs(got.astype(np.int32) - ref)
    assert np.percentile(diff, 99) <= 2 and diff.mean() < 1.0


def test_read_max_frames_and_size_match_jax(clip):
    path, _ = clip
    got = native.video_read(path, max_frames=5, size=32)
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(
        got, jnative.video_read(path, max_frames=5, size=32))
    np.testing.assert_array_equal(got, native.video_read(path, size=32)[:5])
    assert got[:, :12].mean() > 150 and got[:, 20:].mean() < 90


def test_batch_zero_pads_and_reports_failures(cv2, clip, tmp_path):
    path, frames = clip
    short = _write_mp4(cv2, str(tmp_path / "short.mp4"), frames[:4])
    out = native.video_batch([path, short], frames=8, size=48, num_threads=2)
    assert out.shape == (2, 8, 48, 48, 3)
    np.testing.assert_array_equal(
        out, jnative.video_batch([path, short], frames=8, size=48,
                                 num_threads=2))
    assert out[0].any(axis=(1, 2, 3)).all() and out[1, :4].any(
        axis=(1, 2, 3)).all()
    assert not out[1, 4:].any()  # the 4-frame clip is zero-padded
    np.testing.assert_array_equal(
        out[1, :4], native.video_read(short, max_frames=8, size=48)[:4])
    with pytest.raises(IOError):
        native.video_batch([str(tmp_path / "missing.mp4")], frames=4, size=32)


def test_read_video_frame_range_prefers_native(clip, monkeypatch):
    path, _ = clip
    v = video_clips.read_video(path)
    assert v.dtype == np.float32 and v.shape == (12, 48, 64, 3)
    assert 0.0 <= v.min() and v.max() <= 1.0
    np.testing.assert_array_equal(v, jclips.read_video(path))
    np.testing.assert_array_equal(
        video_clips.read_video_cv2(path, 2, 6),
        jclips.read_video_cv2(path, 2, 6))
    assert video_clips.read_video_cv2(path, 2, 6).shape == (4, 48, 64, 3)

    def boom(*a, **k):  # the cv2 route must not run while native is there
        raise AssertionError("cv2 fallback used despite the native decoder")

    monkeypatch.setattr(video_clips, "read_video_cv2", boom)
    np.testing.assert_array_equal(video_clips.read_video(path, end=6), v[:6])
    np.testing.assert_array_equal(video_clips.read_video(path, 2, 6), v[2:6])


@pytest.mark.parametrize("size", [48, 32])
def test_clip_dir_source_over_mp4_matches_jax(cv2, tmp_path, size):
    """Bit for bit at the clip's own size; resized (48 -> 32 px), the
    port's bilinear resize against cv2.resize within 1e-5, the masks of
    the scaled boxes equal."""
    for i, label in enumerate(("Нет", "Удары")):
        clip = tmp_path / f"clip{i}!person,0!(0,1)!{label}"
        clip.mkdir()
        _write_mp4(cv2, str(clip / "video.mp4"), _frames(8 - i, 48, 48, i))
        np.save(clip / "bboxes.npy",
                np.tile(np.asarray([[4, 4, 30, 30]], np.float32), (8, 1)))
    got_src = video_clips.ClipDirSource(str(tmp_path), frame_num=8, size=size)
    want_src = jclips.ClipDirSource(str(tmp_path), frame_num=8, size=size)
    got, want = (s.build_batch([0, 1], pad_to=3) for s in (got_src,
                                                           want_src))
    gv, wv = got["modalities"]["video"], want["modalities"]["video"]
    assert gv["data"].shape == wv["data"].shape == (3, 8, size, size, 3)
    np.testing.assert_allclose(gv["data"], wv["data"], rtol=0,
                               atol=0 if size == 48 else 1e-5)
    assert not gv["data"][1, 7:].any()  # the 7-frame clip's padding
    np.testing.assert_array_equal(gv["mask"], wv["mask"])
    np.testing.assert_array_equal(got["labels"]["main"],
                                  want["labels"]["main"])
