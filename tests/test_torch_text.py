"""The text transformer entry (cli/train_text_transformer.py) against the
JAX package's.

`TransformerSequenceClassifier` (models/heads.py) gives JAX's logits within
1e-5, as tests/test_torch_layers.py holds the encoder, with the same
weights carried by io/from_jax.py (strict load), for each `return_type`;
the entry's model (`SingleHeadAdapter` around it) also gives JAX's CE loss
and every gradient within 1e-4 * max|g_JAX|.  The intervals-table loaders
give JAX's batches one for one, and the CLI trains on the CPU in both data
modes (flat `*_LABEL.npy` files and the table) at tests/test_cli.py's
sizes.
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
    train_text_transformer as jcli)
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.models.heads import (
    TransformerSequenceClassifier as JaxClassifier)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_text_transformer as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    generate_synthetic_avabos)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.heads import (
    TransformerSequenceClassifier)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from test_torch_files import _assert_same_batches
from test_torch_trimodal import random_variables

E, H = 32, 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tokens(seed, b=3, t=9):
    x = np.random.default_rng(seed).standard_normal((b, t, E)).astype(
        np.float32)
    x[0, 6:] = 0.0  # zero-padded token rows, unmasked as in the entry
    return x


@pytest.mark.parametrize("num_layers", [1, 2])
def test_classifier_matches_jax(num_layers):
    x = _tokens(num_layers)
    jm = JaxClassifier(class_num=3, hidden_size=E, num_layers=num_layers,
                       num_heads=H)
    variables = random_variables(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), seed=num_layers)
    port = load_jax_variables(
        TransformerSequenceClassifier(3, E, num_layers, H), variables).eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x), return_type="all")
    want_logits, want_feats = jm.apply(variables, jnp.asarray(x),
                                       return_type="all")
    assert got[0].shape == (3, 3) and got[1].shape == x.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_logits),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_feats),
                               atol=1e-5)
    with torch.inference_mode():
        feats = port(torch.from_numpy(x), return_type="features")
        logits = port(torch.from_numpy(x))
    assert torch.equal(feats, got[1]) and torch.equal(logits, got[0])


def test_entry_model_loss_and_every_gradient_match_jax():
    args = ["--hidden_size", str(E), "--num_heads", str(H),
            "--num_layers", "1", "--text_tokens", "9"]
    jmodel = jcli.make_model(jax_parse_config(jcli.TextConfig, args))
    model = tcli.make_model(parse_config(tcli.TextConfig, args))
    x = _tokens(5, b=4)
    mask = np.ones(4, np.float32)
    b = {"modalities": {"text": {"data": x, "present": mask}},
         "labels": {"main": np.array([0, 1, 1, 0], np.int32)},
         "label_mask": {"main": mask}}
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["modalities"]), seed=6)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, b["modalities"], train=False)
        return _head_losses_and_metrics(
            out, b, {"main": JaxLossSpec("ce")}, 2)[0]

    want_loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    load_jax_variables(model, variables).eval()
    tb = {k: ({m: {f: torch.from_numpy(a) for f, a in d.items()}
               for m, d in v.items()} if k == "modalities" else
              {h: torch.from_numpy(a) for h, a in v.items()})
          for k, v in b.items()}
    total, _ = head_losses_and_metrics(model(tb["modalities"]), tb,
                                       {"main": LossSpec("ce")}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    assert all(k.startswith("inner.") for k in named)
    for name, p in named.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


@pytest.fixture(scope="module")
def avabos_root(tmp_path_factory):
    """tests/test_cli.py's synthetic AVABOS tree (768-wide tokens)."""
    root = str(tmp_path_factory.mktemp("text") / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=6,
                              seed=3, audio_len=24000, video_frames=8,
                              video_hw=32)
    return root


def test_table_loaders_give_the_jax_batches(avabos_root):
    args = ["--dataset_root", avabos_root, "--batch_size", "4"]
    got = tcli.make_loaders(parse_config(tcli.TextConfig, args))
    want = jcli.make_loaders(jax_parse_config(jcli.TextConfig, args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
        for batch in g:
            assert list(batch["labels"]) == ["main"]
            assert list(batch["modalities"]) == ["text"]


def _check_run(trainer, **want_cfg):
    files = set(os.listdir(trainer.run_dir))
    assert {"checkpoint_current", "checkpoint_best_main", "config.json",
            "main_train_log.csv", "main_test_log.csv"} <= files
    for split in ("train", "test"):
        df = pd.read_csv(os.path.join(trainer.run_dir,
                                      f"main_{split}_log.csv"))
        assert df["epoch"].tolist() == [0]
        assert np.isfinite(df["loss"]).all() and "UAR" in df
    cfg = json.load(open(os.path.join(trainer.run_dir, "config.json")))
    for k, v in want_cfg.items():
        assert cfg[k] == v, k
    assert trainer.state.step > 0


def _cli_args(tmp_path, *extra):
    return ["--saving_dir", str(tmp_path / "runs"), "--epoch_num", "1",
            "--batch_size", "4", "--num_layers", "1", "--num_threads", "2",
            "--log_console", "false", "--device", "cpu", *extra]


def test_cli_trains_on_the_intervals_table(tmp_path, avabos_root):
    trainer = tcli.main(_cli_args(tmp_path, "--dataset_root", avabos_root))
    _check_run(trainer, files_root="", device="cpu", num_layers=1)


def test_cli_trains_on_flat_files(tmp_path):
    rng = np.random.default_rng(1)
    for sub, n in (("train", 6), ("test", 3)):
        os.makedirs(tmp_path / "flat" / sub)
        for i in range(n):
            label = "AGGR" if i % 2 else "NOAGGR"
            np.save(tmp_path / "flat" / sub / f"t{i}_{label}.npy",
                    rng.standard_normal((5, E)).astype(np.float32))
    trainer = tcli.main(_cli_args(
        tmp_path, "--files_root", str(tmp_path / "flat"), "--hidden_size",
        str(E), "--num_heads", str(H), "--text_tokens", "8"))
    _check_run(trainer, files_root=str(tmp_path / "flat"), hidden_size=E)
    assert trainer.state.step == 2


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = [a for a in _cli_args(tmp_path, "--dataset_root",
                                 str(tmp_path / "ds"), "--synthetic")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
    assert not (tmp_path / "ds").exists()  # failed before any data work
