"""The 3-D CNN entry (cli/train3dcnn.py) against the JAX package's.

- The entry's model (R3DWithBboxes, 4 classes, alpha 0.4, b2 x 8 frames
  x 32 px with a mask) under the CE on 'main': in train mode, with JAX's
  dropout mask (read from its run) applied on the port's side, the logits
  within 1e-4 of the largest, the loss within 1e-4 and the BatchNorm
  statistics within 1e-5; the loss within 1e-5 and every gradient within
  1e-4 of its tensor's largest against `jax.grad` in eval mode.  Train
  mode's gradients are not compared here: at b2 the BatchNorm backward
  cancels so much that the early layers' gradients move with rounding
  (this port in f32 against itself in float64: 2.6e-3 of stem.bn.bias's
  largest; JAX with float64 convs and its f32 BatchNorm against the port
  in float64: 1.1e-2 at layer1_0.bn1.bias); tests/test_torch_r3d.py holds
  them at a better-conditioned loss.
- 4-class metrics: the confusion matrix, accuracy, per-class precision,
  recall and F1 and their means equal JAX's (1e-12), and the accuracy
  checkpoint criterion's error is 1 - accuracy in both trainers.
- The loaders give JAX's batches: the test split bit for bit; the
  augmented train split with the same masks and labels, its frames
  differing from JAX's cv2 warps by more than 1e-4 in under 2% of the
  values.
- The CLI trains on the CPU (8 frames, 32 px, b4, 1 epoch), 4-class logs,
  and keeps the best checkpoint by accuracy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train3dcnn as jcli
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.ops import metrics as jmetrics
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import train3dcnn as tcli
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    restore_variables)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.ops import metrics
from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from test_torch_files import _assert_same_batches
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SMALL = ["--frame_num", "8", "--video_size", "32", "--batch_size", "4"]


def _batch(seed, n=2, t=8, hw=32):
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, t, hw, hw, 1), np.float32)
    mask[0, :, 4:20, 6:25] = 1.0
    mask[1, 1:, 10:31, 0:13] = 1.0
    return {"modalities": {"video": {
        "data": rng.uniform(0, 1, (n, t, hw, hw, 3)).astype(np.float32),
        "mask": mask, "present": np.ones(n, np.float32)}},
        "labels": {"main": np.array([3, 1], np.int32)},
        "label_mask": {"main": np.ones(n, np.float32)}}


class _FixedDropout(torch.nn.Module):
    """Applies a given keep mask as the dropout does: x / keep or 0."""

    def __init__(self, kept, keep):
        super().__init__()
        self.kept, self.keep = kept, keep

    def forward(self, x):
        return torch.where(self.kept, x / self.keep, 0.0)


def _variables_and_batch():
    jmodel = jcli.make_model(jax_parse_config(jcli.Cnn3DConfig, SMALL))
    b = _batch(0)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["modalities"]), seed=1)
    model = load_jax_variables(
        tcli.make_model(parse_config(tcli.Cnn3DConfig, SMALL)), variables)
    tb = {k: ({m: {f: torch.from_numpy(a) for f, a in d.items()}
               for m, d in v.items()} if k == "modalities" else
              {h: torch.from_numpy(a) for h, a in v.items()})
          for k, v in b.items()}
    return jmodel, variables, b, model, tb


def test_train_mode_forward_matches_jax():
    jmodel, variables, b, model, tb = _variables_and_batch()
    out, state = jax.jit(lambda v, m: jmodel.apply(
        v, m, train=True, rngs={"dropout": jax.random.PRNGKey(7)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: type(mdl).__name__ == "Dropout"
    ))(variables, b["modalities"])
    loss = _head_losses_and_metrics(out, b, {"main": JaxLossSpec("ce")}, 4)[0]
    dropped = jax.tree.leaves(state["intermediates"])
    assert len(dropped) == 1
    model.train()
    # JAX's keep mask, read from its dropout's output: a unit whose input
    # is 0 (ReLU) is 0 either way
    model.r3d.drop = _FixedDropout(torch.from_numpy(
        np.asarray(dropped[0]) != 0), 0.6)
    got = model(tb["modalities"])
    total, _ = head_losses_and_metrics(got, tb, {"main": LossSpec("ce")}, 4)
    want = np.asarray(out["main"])
    assert got["main"].shape == (2, 4)
    np.testing.assert_allclose(got["main"].detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(total.item(), float(loss), rtol=1e-4)
    stats = from_jax_variables({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, state["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(stats)
    for name, ref in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=name)


def test_loss_and_every_gradient_match_jax():
    jmodel, variables, b, model, tb = _variables_and_batch()

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           b["modalities"], train=False)
        return _head_losses_and_metrics(out, b, {"main": JaxLossSpec("ce")},
                                        4)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    total, _ = head_losses_and_metrics(model.eval()(tb["modalities"]), tb,
                                       {"main": LossSpec("ce")}, 4)
    total.backward()
    np.testing.assert_allclose(total.item(), float(loss), rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_four_class_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 37
    preds = rng.integers(0, 4, n)
    labels = rng.integers(0, 4 if seed else 3, n)  # seed 0: class 3 unseen
    mask = (rng.random(n) > 0.2).astype(np.float32)
    cm = metrics.confusion_matrix(torch.from_numpy(preds),
                                  torch.from_numpy(labels), 4,
                                  torch.from_numpy(mask)).numpy()
    want_cm = np.asarray(jmetrics.confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), 4, jnp.asarray(mask)))
    np.testing.assert_array_equal(cm, want_cm)
    got, want = (metrics.metrics_from_confusion(cm),
                 jmetrics.metrics_from_confusion(want_cm))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
        assert np.shape(got[k]) == (() if np.ndim(want[k]) == 0 else (4,))
    trainer = Trainer.__new__(Trainer)
    trainer.checkpoint_criterion = "accuracy"
    assert trainer._error(got) == 1.0 - want["accuracy"]


def test_loaders_give_the_jax_batches(tmp_path):
    args = ["--files_root", str(tmp_path / "clips"), "--synthetic_clips",
            "--synthetic_files", "6", "--num_threads", "1", *SMALL]
    got = tcli.make_loaders(parse_config(tcli.Cnn3DConfig, args))
    want = jcli.make_loaders(jax_parse_config(jcli.Cnn3DConfig, args))
    _assert_same_batches(got[1], want[1])
    for _ in range(2):
        for g, w in zip(got[0], want[0]):
            gv, wv = g["modalities"]["video"], w["modalities"]["video"]
            np.testing.assert_array_equal(gv["mask"], wv["mask"])
            np.testing.assert_array_equal(g["labels"]["main"],
                                          w["labels"]["main"])
            assert gv["data"].shape == wv["data"].shape == (4, 8, 32, 32, 3)
            # perspective's bilinear taps round apart by ~1e-7; the affine's
            # nearest pick moves a pixel where cv2 rounds the other way
            assert np.mean(np.abs(gv["data"] - wv["data"]) > 1e-4) < 0.02


def test_cli_trains_on_the_cpu_and_keeps_the_best_by_accuracy(tmp_path):
    trainer = tcli.main([
        "--files_root", str(tmp_path / "clips"), "--synthetic_clips",
        "--saving_dir", str(tmp_path / "runs"), "--epoch_num", "1",
        "--num_threads", "2", "--log_console", "false", "--device", "cpu",
        *SMALL])
    files = set(os.listdir(trainer.run_dir))
    assert {"checkpoint_current", "checkpoint_best_main", "config.json",
            "main_train_log.csv", "main_test_log.csv"} <= files
    test_log = pd.read_csv(os.path.join(trainer.run_dir,
                                        "main_test_log.csv"))
    assert test_log["epoch"].tolist() == [0]
    assert np.isfinite(test_log["loss"]).all()
    assert len(test_log["recall"][0].strip("[]").split()) == 4
    _, meta = restore_variables(os.path.join(trainer.run_dir,
                                             "checkpoint_best_main"))
    assert meta["criterion"] == "accuracy"
    assert meta["error"] == pytest.approx(1.0 - test_log["accuracy"][0])
    cfg = json.load(open(os.path.join(trainer.run_dir, "config.json")))
    assert cfg["device"] == "cpu" and cfg["class_num"] == 4
    assert trainer.state.step == 2  # 8 train clips at b4
    assert trainer.state.model.r3d.fc2.out_features == 4


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--files_root", str(tmp_path / "clips"),
                   "--synthetic_clips", "--saving_dir",
                   str(tmp_path / "runs")])
    assert not (tmp_path / "clips").exists()
