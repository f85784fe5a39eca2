"""The fused-feature dump (cli/generate_features.py) against the JAX
package's.

- `fused_features` (the PhysVerb model's extractors, then its fusion
  encoder) gives JAX's `fusion(extract_features(batch))` on the same
  weights: within 1e-4 with audio and text, 1e-3 with the video tower in
  (tests/test_torch_trimodal.py's bounds for the Swin3D-T features).
- The CLI on the CPU writes the JAX CLI's files for the same synthetic
  table: the same names, splits, labels and label masks in
  `manifest.csv`, the same modalities and shapes in each file; with
  --path_to_checkpoint a file holds that model's fused tokens of its row.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import (
    generate_features as jcli)
from multimodalaggressionrecognition_tpu_torch.cli import (
    generate_features as tcli)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_multimodal as ttm)
from multimodalaggressionrecognition_tpu_torch.cli.common import (
    ensure_dataset, parse_config)
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    save_variables)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from test_torch_trimodal import _torch, batch, pair  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("present,tol", [("audio,text,video", 1e-3),
                                         ("audio,text", 1e-4)])
def test_fused_features_match_jax(pair, present, tol):
    jmodel, variables, port = pair
    b = {m: v for m, v in batch().items() if m in present.split(",")}
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, y: m.fusion(m.extract_features(y))))(
        variables, b)
    with torch.inference_mode():
        got = tcli.fused_features(port, _torch(b))
    assert sorted(got) == sorted(want) == ["audio", "text", "video"]
    for m in want:
        assert got[m].shape == want[m].shape
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   atol=tol, err_msg=m)


SMALL = ["--synthetic", "--audio_samples", "16000", "--text_tokens", "8",
         "--batch_size", "4", "--fusion_layers", "1"]


def _files(out):
    manifest = pd.read_csv(os.path.join(out, "manifest.csv"))
    arrays = {n: np.load(os.path.join(out, f"{n}.npy"),
                         allow_pickle=True).item() for n in manifest["name"]}
    return manifest, arrays


def test_cli_writes_the_jax_files(tmp_path):
    root = str(tmp_path / "avabos")
    jcli.main(["--dataset_root", root, "--out_dir", str(tmp_path / "jax"),
               "--saving_dir", str(tmp_path / "runs"), *SMALL])
    tcli.main(["--dataset_root", root, "--out_dir", str(tmp_path / "port"),
               "--device", "cpu", *SMALL])
    want_manifest, want = _files(tmp_path / "jax")
    got_manifest, got = _files(tmp_path / "port")
    assert len(want_manifest) > 0
    pd.testing.assert_frame_equal(got_manifest, want_manifest)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays) == ["audio", "text"]
        for m, a in arrays.items():
            assert got[name][m].shape == a.shape and got[name][m].dtype == a.dtype
            assert np.isfinite(got[name][m]).all()


def test_cli_dumps_the_checkpoint_model(tmp_path):
    args = ["--dataset_root", str(tmp_path / "avabos"), "--device", "cpu",
            "--num_threads", "1", *SMALL]
    cfg = parse_config(tcli.GenFeaturesConfig, args)
    df, split = ensure_dataset(cfg)
    modalities = ("audio", "text")
    model = seeded_init_(ttm.build_model(cfg, modalities), 5).eval()
    save_variables(str(tmp_path / "ckpt"), model.state_dict())
    out = tcli.main(args + ["--out_dir", str(tmp_path / "out"),
                            "--path_to_checkpoint", str(tmp_path / "ckpt")])
    first = next(iter(ttm.make_loaders(cfg, df, split, modalities)[0]))
    with torch.inference_mode():
        want = tcli.fused_features(model, _torch(first["modalities"]))
    _, got = _files(out)
    for m in modalities:
        np.testing.assert_allclose(got["train_000000"][m], want[m][0].numpy(),
                                   atol=1e-6, err_msg=m)
