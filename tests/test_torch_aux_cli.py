"""The port's auxiliary CLIs against the JAX package's: show_results,
sweep, prepare_data and doctor.

- show_results: the same CSV logs give equal tables;
- sweep: a 2-point grid of a 1-layer text transformer, 1 epoch each on the
  CPU: the completion markers, sweep_summary.csv, a second call skipping
  both points, and a preempted point stopping the grid unmarked;
- prepare_data: resample-audio and split / make-split write the same bytes
  as the JAX CLI (both packages' native wav loaders off), and with the
  port's native loader on, resample-audio's waveforms within 2e-3 of
  those (1e-6 at 16 kHz, tests/test_native.py);
  decode-videos from an .mp4 too; resize-videos on .npy and .mp4 writes
  the same TCHW .pt files, the values within 1e-6 (the JAX CLI resizes
  with cv2, the port with its plain bilinear resize);
- doctor: the report without a card (`backend: null`, the native wav
  decoder built from native/ and loaded, the mp4 one too or a reason),
  and `--smoke` exiting non-zero without one.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import wavfile

from multimodalaggressionrecognition_tpu.cli import prepare_data as jprep
from multimodalaggressionrecognition_tpu.cli import show_results as jshow
from multimodalaggressionrecognition_tpu.data import (
    generate_synthetic_avabos as jax_generate)
from multimodalaggressionrecognition_tpu_torch.cli import (
    doctor, prepare_data, show_results, sweep, train_text_transformer)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_show_results_matches_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for run in ("01.01.2026, 00-00-00 (a)", "b"):
        (tmp_path / run).mkdir()
        for head in ("phys", "verb"):
            pd.DataFrame({
                "epoch": range(4), "loss": rng.random(4),
                "accuracy": rng.random(4), "UAR": rng.random(4),
                "UAF1": rng.random(4)}).to_csv(
                    tmp_path / run / f"{head}_test_log.csv", index=False)
    # no UAR column, and an empty log: both skipped
    (tmp_path / "c").mkdir()
    pd.DataFrame({"epoch": [0], "loss": [1.0], "accuracy": [0.5]}).to_csv(
        tmp_path / "c" / "main_test_log.csv", index=False)
    pd.DataFrame(columns=["epoch", "loss", "accuracy", "UAR"]).to_csv(
        tmp_path / "c" / "other_test_log.csv", index=False)
    for metric in ("UAR", "UAF1"):
        want = jshow.main(["--saving_dir", str(tmp_path), "--metric", metric])
        printed = capsys.readouterr().out
        got = show_results.main(["--saving_dir", str(tmp_path),
                                 "--metric", metric])
        assert capsys.readouterr().out == printed
        pd.testing.assert_frame_equal(got, want)
        assert len(got) == 4
    assert show_results.main(["--saving_dir", str(tmp_path / "none")]).empty
    assert capsys.readouterr().out.strip() == "no logs found"


def test_sweep_grid_expansion():
    pts = sweep.grid_points(sweep.parse_grid(
        ["learning_rate=1e-3,3e-4", "num_layers=1,2"]))
    assert len(pts) == 4 and all(len(kv) == 2 for _, kv in pts)
    assert "learning_rate-1e-3_num_layers-1" in [s for s, _ in pts]
    with pytest.raises(SystemExit, match="key=v1"):
        sweep.parse_grid(["learning_rate"])


def test_sweep_end_to_end(tmp_path, capsys):
    root = str(tmp_path / "avabos")
    jax_generate(root, num_clusters=3, samples_per_cluster=6, seed=3,
                 audio_len=24000, video_frames=8, video_hw=32)
    saving = str(tmp_path / "runs")
    argv = ["--entry", "train_text_transformer",
            "--grid", "learning_rate=1e-3,1e-5", "--",
            "--dataset_root", root, "--epoch_num", "1", "--batch_size", "4",
            "--num_layers", "1", "--saving_dir", saving, "--device", "cpu",
            "--log_console", "false", "--num_threads", "2"]
    table = sweep.main(argv)
    assert len(table) == 2
    for slug in ("learning_rate-1e-3", "learning_rate-1e-5"):
        run = os.path.join(saving, slug)
        assert os.path.isfile(os.path.join(run, "checkpoint_current"))
        assert json.load(open(os.path.join(run, "sweep_done.json"))) == {
            "point": {"learning_rate": slug.split("-", 1)[1]}}
    assert table.iloc[0]["UAR"] >= table.iloc[1]["UAR"]
    summary = pd.read_csv(os.path.join(saving, "sweep_summary.csv"))
    assert sorted(summary["run"]) == ["learning_rate-1e-3",
                                      "learning_rate-1e-5"]
    capsys.readouterr()
    sweep.main(argv)  # both points done: nothing trains again
    assert capsys.readouterr().out.count("already done") == 2


def test_sweep_stops_on_preemption(tmp_path, monkeypatch, capsys):
    saving = str(tmp_path / "runs")
    launched = []

    def fake_main(args):
        slug = args[args.index("--run_name") + 1]
        launched.append(slug)
        os.makedirs(os.path.join(saving, slug, "checkpoint_preempt"))

    monkeypatch.setattr(train_text_transformer, "main", fake_main)
    assert sweep.main(["--entry", "train_text_transformer",
                       "--grid", "learning_rate=1e-3,1e-5",
                       "--", "--saving_dir", saving]) is None
    assert launched == ["learning_rate-1e-3"]
    assert not os.path.exists(os.path.join(saving, "learning_rate-1e-3",
                                           "sweep_done.json"))
    assert '"preempted"' in capsys.readouterr().out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_files(a, b):
    """The same files under `a` and `b`, byte for byte."""
    names = _tree(a)
    assert names == _tree(b) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_prepare_data_writes_the_jax_files(tmp_path, monkeypatch):
    from multimodalaggressionrecognition_tpu.data import native
    from multimodalaggressionrecognition_tpu_torch.data import (
        native as port_native)

    rng = np.random.default_rng(1)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, rate in enumerate((44100, 16000, 22050)):
        wavfile.write(str(wavs / f"c-{i}_a_0_0.0-1.0_AGGR.wav"), rate,
                      (rng.standard_normal(rate) * 0.1 * 32767).astype(
                          np.int16))
    monkeypatch.setattr(native, "available", lambda: False)
    with monkeypatch.context() as numpy_only:
        numpy_only.setattr(port_native, "available", lambda: False)
        jprep.main(["resample-audio", str(wavs), str(tmp_path / "jax_pt")])
        prepare_data.main(["resample-audio", str(wavs), str(tmp_path / "pt")])
    _same_files(tmp_path / "jax_pt", tmp_path / "pt")
    wav = torch.load(tmp_path / "pt" / "c-0_a_0_0.0-1.0_AGGR.pt",
                     weights_only=True)
    assert wav.shape == (1, 16000)
    assert port_native.available()  # resample-audio then decodes natively
    prepare_data.main(["resample-audio", str(wavs), str(tmp_path / "x")])
    assert _tree(tmp_path / "x") == _tree(tmp_path / "pt")
    for name in _tree(tmp_path / "pt"):
        got, want = (torch.load(tmp_path / d / name, weights_only=True)
                     for d in ("x", "pt"))
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6
                                   if name.startswith("c-1") else 2e-3)

    # make-split and split: the same JSON and the same trees
    table = pd.DataFrame({
        "cluster__indices_combination": ["(0, 2)", "(1,)", "[0, 1]"],
        "rest_indices_combination": ["(1, 3)", "(0, 2, 3)", "(2, 3)"]})
    csv = tmp_path / "!combinations_info_table.csv"
    table.to_csv(csv, index=False)
    trees = {}
    for name, cli in (("jax", jprep), ("port", prepare_data)):
        out = tmp_path / name
        out.mkdir()
        cli.main(["make-split", str(csv), str(out / "split.json"),
                  "--partition_idx", "1"])
        root = out / "ds"
        for c in range(4):
            (root / "verbal" / "pt_waveform").mkdir(parents=True,
                                                    exist_ok=True)
            np.save(root / "verbal" / "pt_waveform"
                    / f"c-{c}_x_0_0.0-1.0_AGGR.npy", np.full(3, c))
        cli.main(["split", str(root), str(out / "split.json")])
        cli.main(["split", str(out / "ds2"), "--combinations_csv", str(csv),
                  "--partition_idx", "0"])
        trees[name] = out
    assert json.loads((trees["port"] / "split.json").read_text()) == {
        "train": [1], "test": [0, 2, 3]}
    _same_files(trees["jax"], trees["port"])
    for split, clusters in (("train", (1,)), ("test", (0, 2, 3))):
        d = trees["port"] / "ds" / split / "verbal" / "pt_waveform"
        assert sorted(os.listdir(d)) == [
            f"c-{c}_x_0_0.0-1.0_AGGR.npy" for c in clusters]


def _same_videos(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        want = torch.load(os.path.join(a, name), weights_only=True)
        got = torch.load(os.path.join(b, name), weights_only=True)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_prepare_data_videos_as_the_jax_cli(tmp_path):
    from test_mp4_decode import _write_mp4

    rng = np.random.default_rng(2)
    npys = tmp_path / "npys"
    npys.mkdir()
    np.save(npys / "c-0_v_0_0.0-1.0_AGGR.npy",
            rng.uniform(0, 255, (5, 48, 40, 3)).astype(np.uint8))
    np.save(npys / "c-1_v_0_0.0-1.0_NOAGGR.npy",
            rng.random((3, 20, 20, 3)).astype(np.float32))
    for cli, out in ((jprep, "jax_pts"), (prepare_data, "pts")):
        cli.main(["resize-videos", str(npys), str(tmp_path / out),
                  "--size", "32"])
    _same_videos(tmp_path / "jax_pts", tmp_path / "pts")

    raw = tmp_path / "raw"
    raw.mkdir()
    frames = rng.uniform(0, 255, (8, 48, 64, 3)).astype(np.uint8)
    frames[:, :24] = 200
    path = _write_mp4(str(raw / "c-2_v_0_0.0-1.0_AGGR.mp4"), frames)
    if not path.endswith(".mp4"):
        os.rename(path, str(raw / "c-2_v_0_0.0-1.0_AGGR.mp4"))
    for cli, tag in ((jprep, "jax_"), (prepare_data, "")):
        cli.main(["decode-videos", str(raw), str(tmp_path / f"{tag}dec"),
                  "--frame_cut", "6"])
        cli.main(["resize-videos", str(raw), str(tmp_path / f"{tag}mp4"),
                  "--size", "16"])
    _same_files(tmp_path / "jax_dec", tmp_path / "dec")
    assert np.load(tmp_path / "dec" / "c-2_v_0_0.0-1.0_AGGR.npy").shape == (
        6, 48, 64, 3)
    _same_videos(tmp_path / "jax_mp4", tmp_path / "mp4")


def test_doctor_reports_without_a_card(capsys):
    report = doctor.main([])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(report))
    assert set(report["versions"]) == {"torch", "cuda_runtime", "numpy",
                                       "scipy"}
    assert set(report["kernels"]["built"]) <= {
        "framed_conv", "roll", "window_attention", "window_attention_bwd"}
    assert report["kernels"]["build_dir"].endswith("_build")
    native = report["native"]
    assert native["libmarhost_wav_decode"] is True
    assert "libmarhost_reason" not in native
    # libmarvideo builds where pkg-config finds libav*, else says why
    assert native["libmarvideo_mp4_decode"] is ("libmarvideo_reason"
                                                not in native)
    assert "smoke" not in report
    if torch.cuda.is_available():
        assert report["backend"] == "cuda" and report["devices"]
    else:
        assert report["backend"] is None and report["backend_error"]


def test_doctor_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_cuda.py "
                    "runs doctor --smoke")
    with pytest.raises(SystemExit, match="needs a CUDA card") as err:
        doctor.main(["--smoke"])
    assert err.value.code  # a message: exit status 1
    assert json.loads(capsys.readouterr().out)["backend"] is None
