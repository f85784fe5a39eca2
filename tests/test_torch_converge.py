"""Convergence of the port's trainer: the port's counterpart of
tests/test_convergence.py::test_converge_trimodal, with the Swin tower
fine-tuned (--video_freeze false).  On the class-separable synthetic AVABOS
fixture both heads must reach a best test UAR of at least 0.9, the JAX
entry's floor.  Slow (minutes on a CPU): not part of the fast lane.
"""

import glob

import pandas as pd
import pytest

pytestmark = [pytest.mark.slow, pytest.mark.converge]


def _best_uar(saving_dir, head):
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
