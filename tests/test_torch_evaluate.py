"""cli/evaluate.py of the port against the JAX package's, and --from_run.

The same weights on both sides: a numpy-filled variables tree of the JAX
audio,text model (hidden 768) is saved twice, as a JAX checkpoint (orbax,
the TrainState `evaluate` restores) and, through io/from_jax.py, as a port
checkpoint.  Both CLIs then evaluate the test split of one synthetic set (2
clusters x 4 samples, 24 000 samples, as tests/test_evaluate_cli.py): equal
accuracy, UAR, UAP and UAF1 per head, the loss within 1e-4.  The JAX CLI
builds its template from the first test batch, and on this set a
tri-modal model's first test batch holds video only, so the JAX side
would lack the audio and text towers (ROADMAP.md, queue 3); the port
builds every tower from the config, and its tri-modal evaluation is held
to a port run's logged test row instead.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import evaluate as jeval
from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu.data import (
    generate_synthetic_avabos as jax_generate)
from multimodalaggressionrecognition_tpu.io import checkpoint as jax_ckpt
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train import Trainer as JaxTrainer
from multimodalaggressionrecognition_tpu_torch.cli import evaluate
from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
from multimodalaggressionrecognition_tpu_torch.cli.common import (
    parse_config)
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    restore_variables, save_variables)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)
from test_torch_trimodal import random_variables

FIXTURE = dict(num_clusters=2, samples_per_cluster=4, seed=9,
               audio_len=24000, video_frames=8, video_hw=32)
MODALITIES = "audio,text"
SIZES = ["--audio_samples", "24000", "--batch_size", "4"]
METRICS = ("accuracy", "UAR", "UAP", "UAF1")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def same_weights(tmp, argv, modalities, seed):
    """A numpy-filled variables tree of the JAX model `argv` builds, saved
    as a JAX TrainState checkpoint and as a port checkpoint; returns (JAX
    path, port path)."""
    cfg = jtm.parse_config(jeval.EvalConfig, argv)
    mods = tuple(modalities.split(","))
    df, split = jtm.ensure_dataset(cfg)
    train_loader, test_loader = jtm.make_loaders(cfg, df, split, mods)
    trainer = JaxTrainer(jtm.build_model(cfg, mods),
                         {"phys": JaxLossSpec("focal"),
                          "verb": JaxLossSpec("ce")},
                         optax.adam(1e-3), train_loader, test_loader,
                         num_classes=2, saving_dir=os.path.join(tmp, "init"),
                         model_name="init", log_console=False)
    state = trainer.init_state(next(iter(test_loader)))
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          {"params": state.params, **state.model_state})
    variables = random_variables(shapes, seed)
    jax_path = os.path.join(tmp, "jax_ckpt")
    jax_ckpt.save_state(jax_path, state.replace(
        params=variables["params"],
        model_state={k: variables[k] for k in state.model_state}))
    port_path = os.path.join(tmp, "port_ckpt")
    model = train_multimodal.build_model(cfg, mods)
    save_variables(port_path, from_jax_variables(
        variables, getattr(model, "jax_renames", ())))
    return jax_path, port_path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("evaluate"))
    root = os.path.join(tmp, "avabos")
    jax_generate(root, **FIXTURE)
    return tmp, root


def test_evaluate_matches_the_jax_cli(dataset, capsys):
    tmp, root = dataset
    argv = ["--dataset_root", root, "--modalities", MODALITIES, *SIZES]
    jax_path, port_path = same_weights(tmp, argv, MODALITIES, seed=4)
    want = jeval.main(argv + ["--path_to_checkpoint", jax_path,
                              "--saving_dir", os.path.join(tmp, "jax_eval")])
    capsys.readouterr()
    got = evaluate.main(argv + ["--path_to_checkpoint", port_path,
                                "--saving_dir", os.path.join(tmp, "eval"),
                                "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want) and "verb" in got
    for head in want:
        for metric in METRICS:
            assert got[head][metric] == pytest.approx(
                float(want[head][metric]), abs=1e-12), (head, metric)
        for metric in ("precision", "recall", "f1"):
            np.testing.assert_array_equal(got[head][metric],
                                          want[head][metric])
        assert abs(got[head]["loss"] - float(want[head]["loss"])) <= 1e-4
        assert printed[head]["UAR"] == pytest.approx(got[head]["UAR"])


@pytest.fixture(scope="module")
def wide_run(dataset):
    """A port run with a non-default architecture, trained on the CPU."""
    tmp, root = dataset
    saving = os.path.join(tmp, "runs")
    train_multimodal.main([
        "--dataset_root", root, "--batch_size", "4", "--epoch_num", "1",
        "--audio_samples", "24000", "--fusion_layers", "2",
        "--adaptor_out", "64", "--modalities", "audio,text",
        "--saving_dir", saving, "--run_name", "m", "--log_console", "false",
        "--num_threads", "2", "--device", "cpu"])
    return root, os.path.join(saving, "m")


def test_from_run_restores_the_architecture(wide_run, tmp_path):
    root, run_dir = wide_run
    saved = json.load(open(os.path.join(run_dir, "config.json")))
    assert saved["fusion_layers"] == 2 and saved["device"] == "cpu"
    ckpt = os.path.join(run_dir, "checkpoint_current")
    results = evaluate.main(["--from_run", run_dir, "--path_to_checkpoint",
                             ckpt, "--saving_dir", str(tmp_path / "a"),
                             "--device", "cpu"])
    assert "verb" in results
    assert all(np.isfinite(m["loss"]) for m in results.values())
    # the default (1 fusion layer, adaptor 256) model refuses the checkpoint
    with pytest.raises(RuntimeError, match="state_dict"):
        evaluate.main(["--dataset_root", root, "--audio_samples", "24000",
                       "--path_to_checkpoint", ckpt, "--batch_size", "4",
                       "--saving_dir", str(tmp_path / "b"),
                       "--device", "cpu"])
    # an inference checkpoint of the same weights evaluates alike
    state_dict, _ = restore_variables(ckpt)
    save_variables(str(tmp_path / "weights"), state_dict)
    again = evaluate.main(["--from_run", run_dir, "--path_to_checkpoint",
                           str(tmp_path / "weights"), "--saving_dir",
                           str(tmp_path / "c"), "--device", "cpu"])
    for head in results:
        assert again[head]["loss"] == results[head]["loss"]


def test_from_run_never_inherits_the_device(wide_run, tmp_path):
    _, run_dir = wide_run
    cfg = parse_config(evaluate.EvalConfig, ["--from_run", run_dir])
    assert cfg.fusion_layers == 2 and cfg.adaptor_out == 64
    assert cfg.device == "cuda"  # the run's "cpu" is not inherited
    # an explicit flag beats the run's value; unpassed sizes keep defaults
    cfg = parse_config(evaluate.EvalConfig, ["--from_run", run_dir,
                                             "--fusion_layers=3"])
    assert cfg.fusion_layers == 3 and cfg.batch_size == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--from_run", run_dir,
                           "--saving_dir", str(tmp_path)])


def test_trimodal_evaluate_reproduces_the_logged_test_row(dataset, tmp_path):
    """A tri-modal port run (the Swin tower fine-tuned, 8 frames at 32 px)
    evaluated through --from_run gives its best epoch's logged test row."""
    import pandas as pd

    _, root = dataset
    saving = str(tmp_path / "runs")
    train_multimodal.main([
        "--dataset_root", root, "--batch_size", "4", "--epoch_num", "1",
        "--audio_samples", "24000", "--video_frames", "8",
        "--video_size", "32", "--modalities", "audio,text,video",
        "--video_freeze", "false", "--saving_dir", saving, "--run_name", "t",
        "--log_console", "false", "--num_threads", "2", "--device", "cpu"])
    run_dir = os.path.join(saving, "t")
    got = evaluate.main(["--from_run", run_dir, "--path_to_checkpoint",
                         os.path.join(run_dir, "checkpoint_best_phys"),
                         "--saving_dir", str(tmp_path / "e"),
                         "--device", "cpu"])
    assert sorted(got) == ["phys", "verb"]
    for head in got:
        row = pd.read_csv(os.path.join(run_dir, f"{head}_test_log.csv"))
        row = row[row["epoch"] == 0].iloc[0]
        for metric in METRICS:
            assert got[head][metric] == pytest.approx(row[metric], abs=1e-12)
        assert abs(got[head]["loss"] - row["loss"]) <= 1e-4


def test_exported_is_refused(tmp_path):
    """--exported is ported (tests/test_torch_export.py); beside a
    checkpoint it is refused, as the artifact's weights are baked in."""
    with pytest.raises(SystemExit, match="conflicts"):
        evaluate.main(["--exported", str(tmp_path), "--path_to_checkpoint",
                       str(tmp_path / "ckpt"), "--device", "cpu"])
