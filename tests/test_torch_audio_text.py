"""The audio,text entry (cli/train_audio_text.py, models/audiotext.py)
against the JAX package's.

With the same weights carried by io/from_jax.py (strict load) and both
models deterministic (JAX `train=False`, the port in eval mode, its CNN1D
stem through the framed conv's plain version):
- `AudioTextualModel`'s logits agree within 1e-4, as
  tests/test_torch_flagship.py holds the flagship's;
- the CE loss within 1e-5, and every gradient within 1e-4 * max|g_JAX| of
  that tensor, as tests/test_torch_train_step.py holds the tri-modal's.
`PairSource` gives JAX's batches one for one and JAX's `batch_is_empty`
(true exactly where `build_batch` drops the batch), and the CLI trains on
the CPU.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_audio_text as jcli
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_audio_text as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    generate_synthetic_avabos)
from multimodalaggressionrecognition_tpu_torch.data.transforms import (
    pad_audio, pad_text)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from test_torch_files import _assert_same_batches
from test_torch_train_step import torch_tree
from test_torch_trimodal import random_variables

E, SAMPLES, TOKENS = 32, 16000, 9
ARGS = ["--hidden_size", str(E), "--audio_samples", str(SAMPLES),
        "--text_tokens", str(TOKENS)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(n=3, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((n, TOKENS, E)).astype(np.float32)
    text[0, 6:] = 0.0  # zero-padded token rows, unmasked as in the entry
    mask = np.ones(n, np.float32)
    return {"modalities": {
        "audio": {"data": (rng.standard_normal((n, SAMPLES)) * 0.1).astype(
            np.float32), "present": mask},
        "text": {"data": text, "present": mask}},
        "labels": {"main": rng.integers(0, 2, n).astype(np.int32)},
        "label_mask": {"main": np.array([1.0] * (n - 1) + [0.0], np.float32)}}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model in eval mode, batch)."""
    jmodel = jcli.make_model(jax_parse_config(jcli.AudioTextConfig, ARGS))
    b = _batch()
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["modalities"]), seed=2)
    model = tcli.make_model(parse_config(tcli.AudioTextConfig, ARGS))
    return jmodel, variables, load_jax_variables(model, variables).eval(), b


def test_model_logits_match_jax(pair):
    jmodel, variables, model, b = pair
    with torch.inference_mode():
        got = model(torch_tree(b["modalities"]))["main"].numpy()
    want = np.asarray(jax.jit(jmodel.apply)(variables,
                                            b["modalities"])["main"])
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_loss_and_every_gradient_match_jax(pair):
    jmodel, variables, model, b = pair

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           b["modalities"], train=False)
        return _head_losses_and_metrics(
            out, b, {"main": JaxLossSpec("ce")}, 2)[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    model.zero_grad(set_to_none=True)
    tb = torch_tree(b)
    total, _ = head_losses_and_metrics(model(tb["modalities"]), tb,
                                       {"main": LossSpec("ce")}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        ref = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


@pytest.fixture(scope="module")
def avabos_root(tmp_path_factory):
    """tests/test_convergence.py's synthetic AVABOS tree at a short clip."""
    root = str(tmp_path_factory.mktemp("audiotext") / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=8,
                              seed=7, audio_len=SAMPLES, video_frames=8,
                              video_hw=32)
    return root


def test_loaders_give_the_jax_batches(avabos_root):
    args = ["--dataset_root", avabos_root, "--batch_size", "4",
            "--audio_samples", str(SAMPLES), "--text_tokens", "20"]
    got = tcli.make_loaders(parse_config(tcli.AudioTextConfig, args))
    want = jcli.make_loaders(jax_parse_config(jcli.AudioTextConfig, args))
    for g, w in zip(got, want):
        _assert_same_batches(g, w)
        for batch in g:
            assert list(batch["labels"]) == ["main"]
            assert sorted(batch["modalities"]) == ["audio", "text"]


def test_pair_source_drops_what_jax_drops(avabos_root):
    """On the whole table, 'phys' rows included: batch_is_empty is JAX's
    and true exactly where build_batch gives None."""
    df = pd.read_csv(os.path.join(avabos_root, "time_intervals.csv"))
    assert set(df["aggr_type"]) == {"verb", "phys", "phys&verb"}
    transforms = {"audio": pad_audio(SAMPLES), "text": pad_text(20)}
    jloader = jcli.make_loaders(jax_parse_config(
        jcli.AudioTextConfig, ["--dataset_root", avabos_root]))[0]
    jsrc = type(jloader.source)(df, avabos_root, ("audio", "text"),
                                transforms=transforms)
    tsrc = tcli.PairSource(df, avabos_root, ("audio", "text"),
                           transforms=transforms)
    for kind, rows in df.groupby("aggr_type").groups.items():
        idx = list(rows)[:3]
        empty = tsrc.batch_is_empty(idx)
        assert empty == jsrc.batch_is_empty(idx) == (kind == "phys"), kind
        got, want = tsrc.build_batch(idx, 4), jsrc.build_batch(idx, 4)
        assert (got is None) == (want is None) == empty, kind


def test_cli_trains_on_the_cpu(tmp_path, avabos_root):
    trainer = tcli.main([
        "--dataset_root", avabos_root, "--saving_dir", str(tmp_path / "runs"),
        "--epoch_num", "1", "--batch_size", "4", "--num_threads", "2",
        "--audio_samples", str(SAMPLES), "--text_tokens", "8",
        "--log_console", "false", "--device", "cpu"])
    files = set(os.listdir(trainer.run_dir))
    assert {"checkpoint_current", "checkpoint_best_main", "config.json",
            "main_train_log.csv", "main_test_log.csv"} <= files
    for split in ("train", "test"):
        log = pd.read_csv(os.path.join(trainer.run_dir,
                                       f"main_{split}_log.csv"))
        assert log["epoch"].tolist() == [0]
        assert np.isfinite(log["loss"]).all() and "UAR" in log
    assert trainer.state.step > 0


def test_cli_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--dataset_root", str(tmp_path / "ds"), "--synthetic",
                   "--saving_dir", str(tmp_path / "runs")])
    assert not (tmp_path / "ds").exists()  # failed before any data work
