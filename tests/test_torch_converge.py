"""Convergence of the port's trainer: the port's counterparts of
tests/test_convergence.py's runs of the tri-modal model (with the Swin
tower fine-tuned, --video_freeze false), the audio,text flagship, the
spectrogram VGG, the text
transformer, the audio,text two-tower model, the video transformer, the
multi-head RNN entries over wav2vec-1 audio features and over video
feature sequences, and the bbox-masked 3-D CNN.  On the class-separable
synthetic fixtures every head of the single-head entries, and the best
head of the multi-head ones (the reference's model selection), must reach
a best test UAR of at least 0.9, the JAX entries' floor.  Slow (minutes on a CPU): not part of the
fast lane.
"""

import glob

import pandas as pd
import pytest

pytestmark = [pytest.mark.slow, pytest.mark.converge]


def _best_uar(saving_dir, head="*"):
    """The best test UAR of `head`, or of any head."""
    files = glob.glob(f"{saving_dir}/*/{head}_test_log.csv")
    assert files, f"no '{head}' test logs under {saving_dir}"
    return max(float(pd.read_csv(f)["UAR"].max()) for f in files)


def test_converge_trimodal_fine_tuned(tmp_path):
    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    root = str(tmp_path / "avabos")
    df, _ = generate_synthetic_avabos(
        root, num_clusters=3, samples_per_cluster=8, seed=7, audio_len=24000,
        video_frames=8, video_hw=32)
    assert df["aggr_type"].nunique() >= 2, df["aggr_type"].value_counts()
    runs = tmp_path / "runs"
    train_multimodal.main([
        "--dataset_root", root, "--saving_dir", str(runs),
        "--epoch_num", "10", "--batch_size", "4", "--log_console", "false",
        "--audio_samples", "24000", "--video_frames", "8",
        "--video_size", "32", "--video_window", "4",
        "--modalities", "audio,text,video", "--video_freeze", "false",
        "--device", "cpu"])
    assert _best_uar(runs, "verb") >= 0.9
    assert _best_uar(runs, "phys") >= 0.9


def test_converge_multimodal(tmp_path):
    """tests/test_convergence.py::test_converge_multimodal's run: the
    audio,text flagship (hidden 768) for 8 epochs at b4 on 24 000-sample
    clips; only 'verb' carries labels without the video modality."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    root = str(tmp_path / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=8,
                              seed=7, audio_len=24000, video_frames=8,
                              video_hw=32)
    runs = tmp_path / "runs"
    train_multimodal.main([
        "--dataset_root", root, "--saving_dir", str(runs),
        "--epoch_num", "8", "--batch_size", "4", "--log_console", "false",
        "--audio_samples", "24000", "--modalities", "audio,text",
        "--device", "cpu"])
    assert _best_uar(runs, "verb") >= 0.9


def test_converge_audio_vgg(tmp_path):
    """tests/test_convergence.py::test_converge_audio_transformer's run: the
    class-coded tones sit at distinct spectrogram bins, and the narrow
    train-time frequency mask cannot wipe both carriers every step."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_audio_transformer)

    runs = tmp_path / "runs"
    train_audio_transformer.main([
        "--files_root", str(tmp_path / "wavs"), "--saving_dir", str(runs),
        "--epoch_num", "8", "--batch_size", "4", "--log_console", "false",
        "--audio_seconds", "1", "--synthetic_files", "16", "--n_fft", "256",
        "--freq_mask", "16", "--time_mask", "16", "--synthetic_wav",
        "--synthetic_tones", "--device", "cpu"])
    assert _best_uar(runs, "main") >= 0.9


def test_converge_text_transformer(tmp_path):
    """tests/test_convergence.py::test_converge_text_transformer's run on
    the intervals table of the synthetic AVABOS fixture."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_text_transformer)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    root = str(tmp_path / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=8,
                              seed=7, audio_len=24000, video_frames=8,
                              video_hw=32)
    runs = tmp_path / "runs"
    train_text_transformer.main([
        "--dataset_root", root, "--saving_dir", str(runs), "--epoch_num",
        "6", "--batch_size", "4", "--num_layers", "1", "--log_console",
        "false", "--device", "cpu"])
    assert _best_uar(runs, "main") >= 0.9


def test_converge_audio_text(tmp_path):
    """tests/test_convergence.py::test_converge_audio_text's run."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_audio_text
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    root = str(tmp_path / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=8,
                              seed=7, audio_len=24000, video_frames=8,
                              video_hw=32)
    runs = tmp_path / "runs"
    train_audio_text.main([
        "--dataset_root", root, "--saving_dir", str(runs), "--epoch_num",
        "8", "--batch_size", "4", "--audio_samples", "24000",
        "--log_console", "false", "--device", "cpu"])
    assert _best_uar(runs, "main") >= 0.9


def test_converge_video_transformer(tmp_path):
    """tests/test_convergence.py::test_converge_video_transformer's run: the
    class brightness of the synthetic clips survives the frozen tower."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_video_transformer)

    runs = tmp_path / "runs"
    train_video_transformer.main([
        "--files_root", str(tmp_path / "vids"), "--saving_dir", str(runs),
        "--epoch_num", "6", "--batch_size", "4", "--video_frames", "8",
        "--video_size", "64", "--video_window", "4", "--synthetic_files",
        "8", "--num_layers", "1", "--synthetic_videos", "--log_console",
        "false", "--device", "cpu"])
    assert _best_uar(runs, "main") >= 0.9


def test_converge_audio_rnn(tmp_path):
    """tests/test_convergence.py::test_converge_audio_rnn's run: the
    class-coded tones survive the wav2vec-1 encoder's group norms."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_audio_rnn

    runs = tmp_path / "runs"
    train_audio_rnn.main([
        "--files_root", str(tmp_path / "wavs"), "--saving_dir", str(runs),
        "--epoch_num", "5", "--batch_size", "4", "--audio_seconds", "1",
        "--extractor", "wav2vec1", "--synthetic_files", "16",
        "--synthetic_wav", "--synthetic_tones", "--log_console", "false",
        "--device", "cpu"])
    assert _best_uar(runs) >= 0.9


def test_converge_video_rnn(tmp_path):
    """tests/test_convergence.py::test_converge_video_rnn's run."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_video_rnn

    runs = tmp_path / "runs"
    train_video_rnn.main([
        "--files_root", str(tmp_path / "feats"), "--saving_dir", str(runs),
        "--epoch_num", "6", "--batch_size", "4", "--feature_dim", "64",
        "--hidden_size", "32", "--synthetic_features", "--log_console",
        "false", "--device", "cpu"])
    assert _best_uar(runs) >= 0.9


def test_converge_3dcnn(tmp_path):
    """tests/test_convergence.py::test_converge_3dcnn's run: the paired
    augmentation (perspective, affine, flip, box mask) runs on every train
    clip, and a wrong warp or raster would wash out the class brightness."""
    from multimodalaggressionrecognition_tpu_torch.cli import train3dcnn

    runs = tmp_path / "runs"
    train3dcnn.main([
        "--files_root", str(tmp_path / "clips"), "--saving_dir", str(runs),
        "--epoch_num", "20", "--batch_size", "4", "--frame_num", "8",
        "--video_size", "32", "--synthetic_files", "16", "--synthetic_clips",
        "--two_class", "--log_console", "false", "--device", "cpu"])
    assert _best_uar(runs, "main") >= 0.9
