"""cli/predict.py of the port against the JAX package's, with the same
weights: a numpy-filled variables tree of the JAX tri-modal model (hidden
768, the real Swin3D-T tower, 24 000 samples, 8 frames at 32 px) saved as
a JAX checkpoint and, through io/from_jax.py, as a port checkpoint.  The
clips: wavs at 44.1 kHz, (20, 768) text .npy, and video .npy as (T, H, W,
3) and (T, 3, H, W) uint8-range frames at 48 px (the /255 rule and the
resize to 32; the JAX CLI resizes with cv2, the port with its plain
bilinear resize) and one (T, H, W, 3) clip already at 32 px in [0, 1].
The printed probabilities (4 decimals) agree within 1e-4.

The JAX CLI draws throwaway initial variables with an eager `model.init`
before it restores the checkpoint (~40 s for the Swin tower on the CPU);
the comparison gives it the same model with a jitted `init`, which draws
the same throwaway values, and every score comes from the restored
weights.
"""

import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from scipy.io import wavfile

from multimodalaggressionrecognition_tpu.cli import predict as jpredict
from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu_torch.cli import predict
from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    save_variables)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)
from test_torch_trimodal import random_variables

SIZES = ["--modalities", "audio,text,video", "--audio_samples", "24000",
         "--video_frames", "8", "--video_size", "32"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(5)
    dirs = {m: tmp / m for m in ("audio", "text", "video")}
    for d in dirs.values():
        d.mkdir()
    for i in range(3):
        wavfile.write(str(dirs["audio"] / f"clip{i}.wav"), 44100,
                      (rng.standard_normal(44100 + 700 * i) * 0.1
                       * 32767).astype(np.int16))
        np.save(str(dirs["text"] / f"clip{i}.npy"),
                rng.standard_normal((20, 768)).astype(np.float32))
    np.save(str(dirs["video"] / "clip0.npy"),
            (rng.random((6, 48, 48, 3)) * 255).astype(np.float32))
    np.save(str(dirs["video"] / "clip1.npy"),
            (rng.random((10, 3, 48, 48)) * 255).astype(np.float32))
    np.save(str(dirs["video"] / "clip2.npy"),
            rng.random((8, 32, 32, 3)).astype(np.float32))
    return tmp, dirs


@pytest.fixture(scope="module")
def checkpoints(clips):
    """(JAX checkpoint, port checkpoint) of the same variables."""
    tmp, _ = clips
    cfg = jtm.parse_config(jpredict.PredictConfig, SIZES)
    mods = ("audio", "text", "video")
    jmodel = jtm.build_model(cfg, mods)
    ones = np.ones((1,), np.float32)
    example = {"audio": {"data": np.zeros((1, 24000), np.float32),
                         "present": ones},
               "text": {"data": np.zeros((1, 48, 768), np.float32),
                        "present": ones},
               "video": {"data": np.zeros((1, 8, 32, 32, 3), np.float32),
                         "present": ones}}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example)
    variables = random_variables(shapes, seed=6)
    jax_path = str(tmp / "jax_ckpt")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.join(jax_path, "state"), {
        "params": variables["params"],
        "model_state": {"batch_stats": variables["batch_stats"]},
        "step": 0})
    ckptr.wait_until_finished()
    port = train_multimodal.build_model(cfg, mods)
    port_path = str(tmp / "port_ckpt")
    save_variables(port_path, from_jax_variables(
        variables, getattr(port, "jax_renames", ())))
    return jax_path, port_path


class _JitInit:
    """A JAX model whose `init` is jitted; everything else is the model's."""

    def __init__(self, model):
        self._model = model
        self.init = jax.jit(model.init)

    def __getattr__(self, name):
        return getattr(self._model, name)


def _rows(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_predict_matches_the_jax_cli(clips, checkpoints, capsys,
                                     monkeypatch):
    _, dirs = clips
    monkeypatch.setattr(jpredict, "build_model",
                        lambda cfg, mods: _JitInit(jtm.build_model(cfg, mods)))
    jax_path, port_path = checkpoints
    files = ["--audio", str(dirs["audio"]), "--text", str(dirs["text"]),
             "--video", str(dirs["video"])]
    capsys.readouterr()
    jpredict.main(SIZES + files + ["--path_to_checkpoint", jax_path])
    want = _rows(capsys)
    predict.main(SIZES + files + ["--path_to_checkpoint", port_path,
                                  "--device", "cpu", "--batch_size", "2"])
    got = _rows(capsys)
    assert [r["clip"] for r in got] == [r["clip"] for r in want] == [
        f"clip{i}.wav" for i in range(3)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["clip", "phys_prob_aggr",
                                          "verb_prob_aggr"]
        for key in ("phys_prob_aggr", "verb_prob_aggr"):
            assert abs(g[key] - w[key]) <= 1e-4 + 1e-9, (g, w)


def test_predict_refuses_what_it_cannot_pair(clips):
    _, dirs = clips
    os.makedirs(dirs["text"].parent / "two", exist_ok=True)
    two = dirs["text"].parent / "two"
    for i in range(2):
        np.save(str(two / f"clip{i}.npy"), np.zeros((4, 768), np.float32))
    with pytest.raises(SystemExit, match="disagree on file counts"):
        predict.main(["--audio", str(dirs["audio"]), "--text", str(two),
                      "--device", "cpu"])
    # default modalities are audio,text: video files need the video tower
    with pytest.raises(SystemExit, match="--modalities"):
        predict.main(["--video", str(dirs["video"]), "--device", "cpu"])
    with pytest.raises(SystemExit, match="nothing to score"):
        predict.main(["--device", "cpu"])


@pytest.mark.parametrize("flags,item", [
    # int8 and w8a8 are ported; a mode that exists nowhere still exits
    pytest.param(["--quantize", "int4"], "unknown quantize mode",
                 id="flags0-item 9"),
    # --exported is ported; the artifact's weights are baked in, so it
    # refuses --quantize beside it
    pytest.param(["--exported", "artifact", "--quantize", "int8"],
                 "conflicts", id="flags1-item 9"),
    # bfloat16 is ported; a compute dtype that exists nowhere still exits
    pytest.param(["--compute_dtype", "fp8"], "unknown compute dtype",
                 id="flags2-item 7")])
def test_predict_refuses_what_is_not_ported(clips, flags, item):
    _, dirs = clips
    with pytest.raises(SystemExit, match=item):
        predict.main(["--audio", str(dirs["audio"]), "--device", "cpu",
                      *flags])


def test_predict_loads_video_as_the_jax_cli(clips):
    """The port's clip loader against the JAX one's (cv2 resize): the same
    (T, H, W, 3) frames in [0, 1], padded to 8, within 1e-6."""
    _, dirs = clips
    for name in ("clip0.npy", "clip1.npy", "clip2.npy"):
        path = str(dirs["video"] / name)
        want = jpredict._load_video(path, 8, 32)
        got = predict._load_video(path, 8, 32)
        assert got.shape == want.shape == (8, 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=1e-6)
