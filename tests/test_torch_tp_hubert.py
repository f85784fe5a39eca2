"""The HuBERT-large tower's tensor-parallel train step in the PyTorch port,
mirroring tests/test_tp_cli.py's
test_hubert_large_tower_tp_matches_single_device: HuBERT-large truncated
to 2 layers (embed 1024, 16 heads, feed-forward 4096) and a 2-way head on
the mean over time, two Adam(1e-4) CE steps at b4 x 3200 samples.

- tp 2 on two gloo CPU ranks (tests/_torch_parallel_child.py, mode
  "tp_hubert", dropout 0.1) against one port process: losses rtol 5e-5 /
  atol 1e-6, the parameter norm within 1e-4 relative (the JAX test's
  bounds);
- one port process against JAX's one-device step on the same weights,
  both with dropout 0.0 (the packages draw their masks from different
  generators), to the same bounds.
"""

import dataclasses

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest
import torch

from _torch_parallel_child import launch
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)

B, SAMPLES = 4, 3200


def _batches():
    rng = np.random.default_rng(0)
    return [{
        "modalities": {"audio": {
            "data": rng.standard_normal((B, SAMPLES)).astype(np.float32),
            "present": np.ones((B,), np.float32)}},
        "labels": {"main": (np.arange(B) % 2).astype(np.int32)},
        "label_mask": {"main": np.ones((B,), np.float32)},
        "sample_mask": np.ones((B,), np.float32),
    } for _ in range(2)]


@pytest.fixture(scope="module")
def hubert_run(tmp_path_factory):
    """JAX's two one-device steps (dropout 0.0) from its init, and one
    launch of the port's ranks from the same weights."""
    from multimodalaggressionrecognition_tpu.models.wav2vec import (
        HUBERT_LARGE, Wav2Vec2Model)
    from multimodalaggressionrecognition_tpu.train import LossSpec
    from multimodalaggressionrecognition_tpu.train.state import (
        create_train_state)
    from multimodalaggressionrecognition_tpu.train.steps import (
        make_train_step)

    cfg = dataclasses.replace(HUBERT_LARGE, num_layers=2, dropout=0.0)

    class Tower(nn.Module):
        @nn.compact
        def __call__(self, modalities, train: bool = False):
            feats = Wav2Vec2Model(cfg, name="hubert")(
                modalities["audio"]["data"], train=train)
            return {"main": nn.Dense(2, name="cls")(feats.mean(axis=1))}

    work = tmp_path_factory.mktemp("hubert")
    batches = _batches()
    model = Tower()
    state = create_train_state(model, batches[0]["modalities"],
                               optax.adam(1e-4))
    torch.save(from_jax_variables(
        {"params": jax.tree.map(np.asarray, state.params)}),
        work / "hubert_weights.pt")
    torch.save([dict(b, labels={"main": b["labels"]["main"].astype(np.int64)})
                for b in batches], work / "hubert_batches.pt")
    step = make_train_step(model, {"main": LossSpec("ce")}, num_classes=2,
                           donate=False)
    dev = jax.devices()[0]
    state = jax.device_put(state, dev)
    losses = []
    for i, raw in enumerate(batches):
        state, m = step(state, jax.device_put(raw, dev),
                        jax.random.PRNGKey(i))
        losses.append(float(m["total_loss"]))
    norm = float(jax.jit(optax.global_norm)(state.params))
    del state
    launch("tp_hubert", 2, work)
    return torch.load(work / "hubert_out.pt", weights_only=False), (
        losses, norm)


def _hold(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=5e-5, atol=1e-6)
    assert abs(got[1] - want[1]) < 1e-4 * max(1.0, want[1]), (got, want)


def test_tp2_step_equals_one_rank(hubert_run):
    out, _ = hubert_run
    _hold(out["tp"], out["one"])


def test_one_rank_step_matches_jax(hubert_run):
    out, jax_out = hubert_run
    _hold(out["plain"], jax_out)
