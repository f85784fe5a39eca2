"""The feature extraction entry (cli/extract_features.py) against the JAX
package's.

- For each backbone (Swin3D-T with its polynomial GELU, R3D-18, S3D) the
  entry's windowed extractor gives JAX's `make_extractor` features within
  1e-4 of the largest, on the same weights (random BatchNorm statistics
  and LayerNorm parameters) carried by io/from_jax.py, on 2 clips of 32
  frames at 64 px in 16-frame windows.  At 64 px the Swin's patch grid is
  8 x 16 x 16, so its window is the full (8, 7, 7) (N = 392) and its
  shifted blocks roll and mask as at 112 px.
- The CLI on the CPU writes the JAX CLI's files: the same names under
  test/, train/0/ and train/1/ (--num_epochs 1), pinned order and
  membership with --train_names / --test_names, and (T / window, D)
  arrays; the lag-1 readback and MAR_EXTRACT_PIPELINE=0 write the same
  bytes; the CUDA default raises without a card.
"""

import os

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import extract_features as jcli
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu_torch.cli import (
    extract_features as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    make_synthetic_videos)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from test_torch_trimodal import random_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


DIMS = {"swin3d_t": 768, "r3d18": 512, "s3d": 1024}


@pytest.mark.parametrize("backbone", sorted(DIMS))
def test_windowed_extractor_matches_jax(backbone):
    args = ["--backbone", backbone, "--frame_num", "32", "--window", "16"]
    jmodel = jcli.make_extractor(jax_parse_config(jcli.ExtractConfig, args))
    x = (np.random.default_rng(0).standard_normal((2, 32, 64, 64, 3))
         * 0.5).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x[:1]), seed=1)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    model = load_jax_variables(
        tcli.make_extractor(parse_config(tcli.ExtractConfig, args)),
        variables).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, DIMS[backbone])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _tree(root):
    """{relative path: array shape} of every .npy under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = np.load(
                os.path.join(d, f)).shape
    return out


def test_cli_writes_the_jax_files(tmp_path, monkeypatch):
    vids = str(tmp_path / "vids")
    make_synthetic_videos(vids, n_train=3, n_test=2, frames=40, hw=32)
    pins = {}
    for sub in ("train", "test"):  # reversed, the train pin one short
        names = sorted(os.listdir(os.path.join(vids, sub)))[::-1]
        names = names[:2] if sub == "train" else names
        pins[sub] = names
        (tmp_path / f"{sub}.txt").write_text("\n".join(names) + "\n")
    common = ["--files_root", vids, "--backbone", "r3d18", "--frame_num",
              "48", "--window", "16", "--batch_size", "2", "--num_epochs",
              "1", "--train_names", str(tmp_path / "train.txt"),
              "--test_names", str(tmp_path / "test.txt")]
    jcli.main(common + ["--out_root", str(tmp_path / "jax")])
    tcli.main(common + ["--out_root", str(tmp_path / "port"), "--device",
                        "cpu"])
    monkeypatch.setenv("MAR_EXTRACT_PIPELINE", "0")
    tcli.main(common + ["--out_root", str(tmp_path / "sequential"),
                        "--device", "cpu"])
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want
    assert sorted(want) == sorted(
        [os.path.join("test", n.replace(".pt", ".npy")) for n in pins["test"]]
        + [os.path.join("train", e, n.replace(".pt", ".npy"))
           for e in ("0", "1") for n in pins["train"]])
    assert set(want.values()) == {(3, 512)}
    for rel in want:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "sequential" / rel).read_bytes()), rel
    # train/1 is the augmented re-extraction: it differs from train/0
    first = os.path.join("train", "0", pins["train"][0].replace(".pt",
                                                                ".npy"))
    again = first.replace(f"train{os.sep}0", f"train{os.sep}1")
    assert not np.array_equal(np.load(tmp_path / "port" / first),
                              np.load(tmp_path / "port" / again))


def test_cli_refuses_bf16_and_a_missing_card(tmp_path):
    """Without a card the CUDA default raises.  (bfloat16 is no longer
    refused: tests/test_torch_bf16_entries.py runs it against the JAX
    CLI.)"""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--files_root", str(tmp_path)])
