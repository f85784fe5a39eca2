"""The port's flat-file data path (data/files.py, the synthetic wav fixture,
cli/common.py's names pin) against the JAX package's.

The same files give the same batches, one for one and array for array,
through both packages' sources, samplers and loaders: wavs at 16 kHz and at
44.1 kHz (resampled on the host), `.npy` sequences, and a names pin, over
two epochs (the sampler reshuffles with seed + epoch).  The synthetic wav
fixture is byte-equal to JAX's, and the port's counterparts of
tests/test_names_pin.py pass.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from multimodalaggressionrecognition_tpu.cli import (
    train_audio_transformer as jaudio, train_text_transformer as jtext)
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.cli.train_audio_rnn import (
    _make_synthetic_wavs as jax_make_wavs)
from multimodalaggressionrecognition_tpu.data.files import (
    FilenameLabelSource as JaxSource, RandomBatchSampler as JaxSampler)
from multimodalaggressionrecognition_tpu.data.pipeline import (
    BatchLoader as JaxLoader)
from multimodalaggressionrecognition_tpu.data.transforms import (
    pad_audio as jax_pad_audio)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_audio_transformer as taudio, train_text_transformer as ttext)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.files import (
    FilenameLabelSource, RandomBatchSampler, read_names_file)
from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
    BatchLoader)
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_wavs)
from multimodalaggressionrecognition_tpu_torch.data.transforms import (
    pad_audio)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_same_batches(got_loader, want_loader, epochs=2):
    for _ in range(epochs):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            gf, wf = dict(_flat(g)), dict(_flat(w))
            assert sorted(gf) == sorted(wf)
            for k in wf:
                assert gf[k].dtype == wf[k].dtype, k
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)


def _write_wavs(root, rate, n=5, seconds=0.5):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(rate)
    for i in range(n):
        label = "AGGR" if i % 2 else "NOAGGR"
        wav = rng.standard_normal(int(rate * seconds)) * 0.2
        wavfile.write(os.path.join(root, f"c{i}_{label}.wav"), rate,
                      (wav * 32767).astype(np.int16))


def _write_npys(root, names, shape=(5, 8)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for n in names:
        np.save(os.path.join(root, n),
                rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("rate", [16000, 44100])
def test_wav_loaders_give_the_jax_batches(tmp_path, rate):
    root = str(tmp_path / "wavs")
    _write_wavs(root, rate)
    loaders = []
    for source, sampler, loader, pad, threads in (
            (FilenameLabelSource, RandomBatchSampler, BatchLoader, pad_audio,
             3),
            (JaxSource, JaxSampler, JaxLoader, jax_pad_audio, 1)):
        src = source(root, "audio", transform=pad(9000), target_rate=16000,
                     heads=("main", "aux"))
        loaders.append(loader(src, sampler(len(src), 2, True, seed=4),
                              pad_to=2, num_threads=threads))
    _assert_same_batches(*loaders)


def test_npy_loaders_with_a_names_pin_give_the_jax_batches(tmp_path):
    names = [f"s{i}_{'AGGR' if i % 3 else 'NOAGGR'}.npy" for i in range(7)]
    _write_npys(str(tmp_path), names)
    pin = tmp_path / "names.txt"
    pin.write_text("\n".join(names[5:0:-1]) + "\n", encoding="utf-8")
    pinned = read_names_file(str(pin))
    loaders = [loader(source(str(tmp_path), "text", files=pinned),
                      sampler(len(pinned), 3, True, seed=1), pad_to=3,
                      num_threads=2)
               for source, sampler, loader in (
                   (FilenameLabelSource, RandomBatchSampler, BatchLoader),
                   (JaxSource, JaxSampler, JaxLoader))]
    assert loaders[0].source.files == pinned
    _assert_same_batches(*loaders)


def test_audio_cli_loaders_give_the_jax_batches(tmp_path):
    """Both CLIs' make_loaders on the same synthetic tones, train and
    test."""
    args = ["--files_root", str(tmp_path / "wavs"), "--synthetic_wav",
            "--synthetic_tones", "--synthetic_files", "6", "--batch_size",
            "4", "--audio_seconds", "1"]
    got = taudio.make_loaders(parse_config(taudio.AudioTransformerConfig,
                                           args))
    want = jaudio.make_loaders(jax_parse_config(jaudio.AudioTransformerConfig,
                                                args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)


@pytest.mark.parametrize("tones", [False, True])
def test_synthetic_wavs_are_byte_equal_to_jax(tmp_path, tones):
    make_synthetic_wavs(str(tmp_path / "port"), 16000, n_train=3, n_test=2,
                        seed=5, tones=tones)
    jax_make_wavs(str(tmp_path / "jax"), 16000, n_train=3, n_test=2, seed=5,
                  tones=tones)
    for sub in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        for n in names:
            assert ((tmp_path / "port" / sub / n).read_bytes()
                    == (tmp_path / "jax" / sub / n).read_bytes()), n


def test_native_wav_loader_is_not_ported(tmp_path, monkeypatch):
    """The name predates the port of the native loader: MAR_USE_NATIVE_WAV=1
    now decodes through data/native.py, as the JAX source does, equal to
    it at 16 kHz (1e-6, tests/test_native.py's exact case) and within 2e-3
    of numpy after a 44.1 kHz resample (`:40`); with the library
    unavailable it decodes with numpy again."""
    from multimodalaggressionrecognition_tpu_torch.data import native

    for rate in (16000, 44100):
        _write_wavs(str(tmp_path / str(rate)), rate, n=2)
    sources = {rate: (FilenameLabelSource(str(tmp_path / str(rate)), "audio"),
                      JaxSource(str(tmp_path / str(rate)), "audio"))
               for rate in (16000, 44100)}
    numpy_wavs = {rate: src.load(1)[0] for rate, (src, _) in sources.items()}
    assert numpy_wavs[16000].shape == numpy_wavs[44100].shape == (8000,)
    monkeypatch.setenv("MAR_USE_NATIVE_WAV", "1")
    assert native.available()
    for rate, (src, jsrc) in sources.items():
        got, want = src.load(1)[0], jsrc.load(1)[0]
        assert got.shape == want.shape == (8000,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6 if rate == 16000
                                   else 2e-3)
        np.testing.assert_allclose(got, numpy_wavs[rate], atol=1e-6
                                   if rate == 16000 else 2e-3)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(sources[44100][0].load(1)[0],
                                  numpy_wavs[44100])


# tests/test_names_pin.py's cases, on the port


def test_read_names_file_drops_blanks_keeps_order(tmp_path):
    p = tmp_path / "train_names.txt"
    p.write_text("b_AGGR.npy\r\n\n  a_NOAGGR.npy  \nc_AGGR.npy\n\n",
                 encoding="utf-8")
    assert read_names_file(str(p)) == ["b_AGGR.npy", "  a_NOAGGR.npy  ",
                                       "c_AGGR.npy"]


def test_pinned_source_order_and_missing_name(tmp_path):
    _write_npys(str(tmp_path), ["a_NOAGGR.npy", "b_AGGR.npy", "c_AGGR.npy"])
    pinned = ["c_AGGR.npy", "a_NOAGGR.npy"]  # a subset, not sorted
    src = FilenameLabelSource(str(tmp_path), "text", files=pinned)
    assert src.files == pinned
    assert list(src.labels()) == [1, 0]
    with pytest.raises(FileNotFoundError):
        FilenameLabelSource(str(tmp_path), "text", files=["nope_AGGR.npy"])


def test_pinned_source_rejects_unsupported_extension(tmp_path):
    _write_npys(str(tmp_path), ["a_NOAGGR.npy"])
    (tmp_path / "b_AGGR.mp4").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="unsupported extension"):
        FilenameLabelSource(str(tmp_path), "video",
                            files=["a_NOAGGR.npy", "b_AGGR.mp4"])


def test_pinned_source_set_root_revalidates(tmp_path):
    names = ["a_NOAGGR.npy", "b_AGGR.npy"]
    _write_npys(str(tmp_path / "ep0"), names)
    _write_npys(str(tmp_path / "ep1"), names[:1])  # b_AGGR missing
    src = FilenameLabelSource(str(tmp_path / "ep0"), "video", files=names)
    with pytest.raises(FileNotFoundError):
        src.set_root(str(tmp_path / "ep1"))
    assert src.root == str(tmp_path / "ep0")  # unchanged on failure
    free = FilenameLabelSource(str(tmp_path / "ep0"), "video")
    free.set_root(str(tmp_path / "ep1"))
    assert free.root == str(tmp_path / "ep1")


@pytest.mark.parametrize("cli", ["text", "audio"])
def test_cli_loaders_honor_names_pin(tmp_path, cli):
    """--train_names reaches FilenameLabelSource through argparse; the
    unpinned split keeps the sorted listing."""
    train_names = ["d_AGGR.npy", "c_NOAGGR.npy", "b_AGGR.npy", "a_NOAGGR.npy"]
    test_names = ["t0_NOAGGR.npy", "t1_AGGR.npy"]
    _write_npys(str(tmp_path / "flat" / "train"), train_names)
    _write_npys(str(tmp_path / "flat" / "test"), test_names)
    pin = tmp_path / "train_names.txt"
    pinned = ["c_NOAGGR.npy", "a_NOAGGR.npy", "d_AGGR.npy"]
    pin.write_text("\n".join(pinned) + "\n", encoding="utf-8")
    module, config = ((ttext, ttext.TextConfig) if cli == "text" else
                      (taudio, taudio.AudioTransformerConfig))
    cfg = parse_config(config, ["--files_root", str(tmp_path / "flat"),
                                "--train_names", str(pin),
                                "--batch_size", "2"])
    train_loader, test_loader = module.make_loaders(cfg)
    assert train_loader.source.files == pinned
    assert test_loader.source.files == sorted(test_names)


def test_text_cli_flat_loaders_give_the_jax_batches(tmp_path):
    names = [f"x{i}_{'AGGR' if i % 2 else 'NOAGGR'}.npy" for i in range(5)]
    for sub in ("train", "test"):
        _write_npys(str(tmp_path / "flat" / sub), names, shape=(6, 16))
    args = ["--files_root", str(tmp_path / "flat"), "--batch_size", "2",
            "--text_tokens", "8", "--hidden_size", "16"]
    got = ttext.make_loaders(parse_config(ttext.TextConfig, args))
    want = jtext.make_loaders(jax_parse_config(jtext.TextConfig, args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
