"""The video transformer entry (cli/train_video_transformer.py) against the
JAX package's.

- `resize_matrix` and `resize_bilinear` (ops/video.py) give JAX's within
  1e-5 at tests/test_video_models.py's shapes: an upscale, an antialiased
  downscale and a plain bilinear one.
- The entry's model (a resize 48 -> 32 px, the frozen Swin3D-T over 4-frame
  windows, a 1-layer transformer head) gives JAX's logits within 1e-4, as
  tests/test_torch_swin3d.py holds the Swin tower, with the same weights
  carried by io/from_jax.py (strict load).  At 32 px stage 0's grid is
  8 x 8, so its shifted block rolls (ops/cuda/roll.py); at 24 px every
  shift would clamp to 0.
- The class-weighted CE loss and every head gradient match `jax.grad`
  within 1e-4 * max|g_JAX|; the frozen tower has none.
- The synthetic videos are byte-equal to JAX's, the loaders give JAX's
  batches one for one, and the CLI trains on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import (
    train_video_transformer as jcli)
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.ops import video as jvideo
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_video_transformer as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_videos)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.ops.video import (
    resize_bilinear, resize_matrix)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from test_torch_files import _assert_same_batches
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# (in H, in W, out H, out W, antialias): tests/test_video_models.py's
# upscale 64 x 48 -> 112, antialiased downscale -> 32 x 24 and plain
# bilinear 20 x 30 -> 9 x 14; and the entry's 128 -> 112 and 48 -> 32
RESIZES = [(64, 48, 112, 112, True), (64, 48, 32, 24, True),
           (20, 30, 9, 14, False), (128, 128, 112, 112, True),
           (48, 48, 32, 32, True), (48, 48, 32, 32, False)]


@pytest.mark.parametrize("h,w,oh,ow,antialias", RESIZES)
def test_resize_matches_jax(h, w, oh, ow, antialias):
    for n_in, n_out in ((h, oh), (w, ow)):
        np.testing.assert_array_equal(
            resize_matrix(n_in, n_out, antialias).numpy(),
            np.asarray(jvideo.resize_matrix(n_in, n_out, antialias)))
    x = np.random.default_rng(h + w).standard_normal((2, 3, h, w, 3)).astype(
        np.float32)
    got = resize_bilinear(torch.from_numpy(x), oh, ow, antialias).numpy()
    want = np.asarray(jvideo.resize_bilinear(jnp.asarray(x), oh, ow,
                                             antialias))
    assert got.shape == want.shape == (2, 3, oh, ow, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


SMALL = ["--video_frames", "8", "--video_size", "32", "--video_window", "4",
         "--num_layers", "1"]


def _models_and_variables(seed=0):
    jmodel = jcli.make_model(jax_parse_config(jcli.VideoTransformerConfig,
                                              SMALL))
    model = tcli.make_model(parse_config(tcli.VideoTransformerConfig, SMALL))
    x = {"video": {"data": jnp.zeros((2, 8, 48, 48, 3))}}
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x), seed=seed)
    return jmodel, load_jax_variables(model, variables).eval(), variables


def _batch(seed):
    rng = np.random.default_rng(seed)
    video = (rng.standard_normal((3, 8, 48, 48, 3)) * 0.5).astype(np.float32)
    mask = np.array([1, 1, 0], np.float32)
    return {"modalities": {"video": {"data": video, "present": mask}},
            "labels": {"main": np.array([0, 1, 1], np.int32)},
            "label_mask": {"main": mask}}


def _torch_batch(b):
    return {k: ({m: {f: torch.from_numpy(a) for f, a in d.items()}
                 for m, d in v.items()} if k == "modalities" else
                {h: torch.from_numpy(a) for h, a in v.items()})
            for k, v in b.items()}


def test_model_logits_match_jax():
    jmodel, model, variables = _models_and_variables(seed=1)
    b = _batch(2)
    with torch.inference_mode():
        got = model(_torch_batch(b)["modalities"])["main"].numpy()
    want = np.asarray(jax.jit(jmodel.apply)(variables,
                                            b["modalities"])["main"])
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_weighted_loss_and_every_head_gradient_match_jax():
    jmodel, model, variables = _models_and_variables(seed=3)
    b = _batch(4)
    specs = (JaxLossSpec("weighted_ce", class_weights=(0.5, 2.0)),
             LossSpec("weighted_ce", class_weights=(0.5, 2.0)))

    def loss_fn(params):
        out = jmodel.apply({"params": params}, b["modalities"], train=False)
        return _head_losses_and_metrics(out, b, {"main": specs[0]}, 2)[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    tb = _torch_batch(b)
    total, _ = head_losses_and_metrics(model(tb["modalities"]), tb,
                                       {"main": specs[1]}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)},
                              model.jax_renames)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    trained = {k for k, p in named.items() if p.requires_grad}
    assert trained and all(k.startswith("head.") for k in trained)
    for name, p in named.items():
        ref = want[name].numpy()
        if name not in trained:  # the frozen tower: JAX stops its gradient
            assert p.grad is None and not ref.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


def test_synthetic_videos_are_byte_equal_to_jax(tmp_path):
    kw = dict(n_train=3, n_test=2, frames=4, hw=8, seed=5)
    jcli._make_synthetic_videos(str(tmp_path / "jax"), **kw)
    make_synthetic_videos(str(tmp_path / "port"), **kw)
    for sub in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == kw[f"n_{sub}"]
        for n in names:
            assert ((tmp_path / "port" / sub / n).read_bytes()
                    == (tmp_path / "jax" / sub / n).read_bytes()), n


@pytest.mark.parametrize("pinned", [False, True])
def test_loaders_give_the_jax_batches(tmp_path, pinned):
    root = tmp_path / "vids"
    args = ["--files_root", str(root), "--synthetic_videos",
            "--synthetic_files", "6", "--batch_size", "4",
            "--video_frames", "40"]
    if pinned:  # a pinned order: the reverse of the listing
        make_synthetic_videos(str(root), n_train=6, n_test=3)
        for sub in ("train", "test"):
            names = sorted(os.listdir(root / sub))[::-1]
            (tmp_path / f"{sub}.txt").write_text("\n".join(names) + "\n")
            args += [f"--{sub}_names", str(tmp_path / f"{sub}.txt")]
    got = tcli.make_loaders(parse_config(tcli.VideoTransformerConfig, args))
    want = jcli.make_loaders(jax_parse_config(jcli.VideoTransformerConfig,
                                              args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
        for batch in g:
            assert batch["modalities"]["video"]["data"].shape == (
                4, 40, 64, 64, 3)


def test_cli_trains_on_the_cpu(tmp_path):
    trainer = tcli.main([
        "--files_root", str(tmp_path / "vids"), "--synthetic_videos",
        "--synthetic_files", "4", "--saving_dir", str(tmp_path / "runs"),
        "--epoch_num", "1", "--batch_size", "2", "--num_threads", "2",
        "--log_console", "false", "--device", "cpu", *SMALL])
    files = set(os.listdir(trainer.run_dir))
    assert {"checkpoint_current", "checkpoint_best_main", "config.json",
            "main_train_log.csv", "main_test_log.csv"} <= files
    for split in ("train", "test"):
        df = pd.read_csv(os.path.join(trainer.run_dir,
                                      f"main_{split}_log.csv"))
        assert df["epoch"].tolist() == [0]
        assert np.isfinite(df["loss"]).all() and "UAR" in df
    cfg = json.load(open(os.path.join(trainer.run_dir, "config.json")))
    assert cfg["device"] == "cpu" and cfg["video_size"] == 32
    assert trainer.state.step == 2
    # the frozen tower is not optimized: only the head's parameters are
    trained = {id(p) for g in trainer.state.optimizer.param_groups
               for p in g["params"]}
    assert trained == {id(p) for p in trainer.state.model.head.parameters()}


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--files_root", str(tmp_path / "vids"),
                   "--synthetic_videos", "--saving_dir",
                   str(tmp_path / "runs")])
    assert not (tmp_path / "vids").exists()  # failed before any data work
