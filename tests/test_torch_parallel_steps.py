"""Multi-rank steps of the PyTorch port on gloo CPU ranks, held to the JAX
package (parallel/, train/steps.py, models/layers.py, models/nn1d.py).

- 2 data ranks: the CNN1D SGD step of tests/test_dp_correctness.py against
  the JAX one-device step on the same weights (loss rtol 1e-5, confusion
  exact, parameters atol 1e-5 / rtol 1e-4, BatchNorm statistics 1e-5);
- 2 data ranks against 1 rank of the port, with dropout on, and with one
  rank's phys rows all masked (its loss still the global one): 1e-6;
- tp 2 and dp 2 x tp 2: the TransformerEncoder of
  tests/test_tensor_parallel.py against `m.apply` (1e-5) and `jax.grad`
  (atol 2e-4, rtol 1e-4), the small Wav2Vec2Model forward (1e-5), and the
  gathered state equal to `from_jax_variables`' bit for bit.

The ranks are separate interpreters (tests/_torch_parallel_child.py) that
import no JAX; this file makes their inputs and holds their outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parallel_child import launch
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)
from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import _batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """One 2-rank launch of the child's "steps" mode, and the JAX step."""
    from multimodalaggressionrecognition_tpu.models.cnn1d import CNN1D
    from multimodalaggressionrecognition_tpu.train import LossSpec
    from multimodalaggressionrecognition_tpu.train.state import (
        create_train_state)
    from multimodalaggressionrecognition_tpu.train.steps import (
        SingleHeadAdapter, make_train_step)

    work = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(0)
    b = 16
    batch = {
        "modalities": {"audio": {
            "data": rng.standard_normal((b, 20000)).astype(np.float32) * 0.3,
            "present": np.ones((b,), np.float32)}},
        "labels": {"main": (np.arange(b) % 2).astype(np.int32)},
        "label_mask": {"main": np.ones((b,), np.float32)},
        "sample_mask": np.ones((b,), np.float32),
    }
    model = SingleHeadAdapter(inner=CNN1D(2, dropout=0.0,
                                          classifier_dropout=0.0),
                              modality="audio", head="main")
    state = create_train_state(model, batch["modalities"], optax.sgd(1.0))
    step = make_train_step(model, {"main": LossSpec("ce")}, num_classes=2,
                           donate=False)
    s1, m1 = step(state, jax.tree.map(jnp.asarray, batch),
                  jax.random.PRNGKey(0))
    before = from_jax_variables({"params": _np(state.params),
                                 **_np(state.model_state)})
    after = from_jax_variables({"params": _np(s1.params),
                                **_np(s1.model_state)})
    torch.save(before, work / "cnn1d_weights.pt")
    port_batch = dict(batch, labels={"main": batch["labels"]["main"].astype(
        np.int64)})
    torch.save(port_batch, work / "cnn1d_batch.pt")

    torch.save(_batch(8), work / "dropout_batch.pt")
    masked = _batch(8)
    masked["labels"]["phys"] = (np.arange(8) % 2).astype(np.int64)
    masked["label_mask"]["phys"] = np.array([1, 1, 1, 0, 0, 0, 0, 0],
                                            np.float32)
    torch.save(masked, work / "masked_batch.pt")
    launch("steps", 2, work)
    jax_out = {"loss": float(m1["total_loss"]),
               "confusion": np.asarray(m1["main"]["confusion"]),
               "state_dict": after}
    return work, jax_out


def test_two_rank_cnn1d_step_matches_jax(steps_run):
    work, want = steps_run
    got = torch.load(work / "cnn1d_out.pt", weights_only=False)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  want["confusion"])
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for name, ref in want["state_dict"].items():
        tol = (dict(atol=1e-5, rtol=1e-5) if "running" in name
               else dict(atol=1e-5, rtol=1e-4))
        np.testing.assert_allclose(got["state_dict"][name].numpy(),
                                   ref.numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("case", ["dropout", "masked"])
def test_two_ranks_equal_one_rank(steps_run, case):
    """Dropout and stochastic masks are drawn for the global batch, and a
    head masked out on one rank gets its global loss: 2 ranks == 1."""
    work, _ = steps_run
    got = torch.load(work / f"{case}_out.pt", weights_only=False)
    np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=0,
                               atol=1e-6)
    # the gradients and the BatchNorm statistics; not the parameters after
    # Adam, whose update of a gradient that is ~0 in exact arithmetic (a
    # bias before BatchNorm) is +-lr whatever its rounding
    names = [n for n in got["ref_state_dict"]
             if n.endswith((".grad", "running_mean", "running_var"))]
    assert len(names) > 20
    for name in names:
        np.testing.assert_allclose(got["state_dict"][name].numpy(),
                                   got["ref_state_dict"][name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def tp_reference(tmp_path_factory):
    """JAX's encoder forward and gradients and the Wav2Vec2 forward; the
    port weights written for the ranks."""
    from multimodalaggressionrecognition_tpu.models.layers import (
        TransformerEncoder)
    from multimodalaggressionrecognition_tpu.models.wav2vec import (
        Wav2Vec2Config, Wav2Vec2Model)

    work = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    m = TransformerEncoder(d_model=64, nhead=4, num_layers=2,
                           dim_feedforward=128)
    x = rng.standard_normal((8, 10, 64)).astype(np.float32)
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.sum(m.apply({"params": p},
                                               jnp.asarray(x)) ** 2))(
        variables["params"])
    weights = from_jax_variables(_np(variables))
    torch.save(weights, work / "encoder_weights.pt")
    torch.save(x, work / "encoder_x.pt")

    cfg = Wav2Vec2Config(conv_layers=((32, 10, 5), (32, 3, 2)), embed_dim=32,
                         num_layers=2, num_heads=4, ff_dim=64,
                         pos_conv_kernel=16, pos_conv_groups=4)
    w2v = Wav2Vec2Model(cfg)
    wx = (rng.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    wvars = jax.jit(w2v.init)(jax.random.PRNGKey(0), jnp.asarray(wx))
    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import (
        Wav2Vec2Config as PortConfig, Wav2Vec2Model as PortModel)

    port_w2v = PortModel(PortConfig(
        conv_layers=((32, 10, 5), (32, 3, 2)), embed_dim=32, num_layers=2,
        num_heads=4, ff_dim=64, pos_conv_kernel=16, pos_conv_groups=4))
    torch.save(from_jax_variables(_np(wvars),
                                  getattr(port_w2v, "jax_renames", ())),
               work / "w2v_weights.pt")
    torch.save(wx, work / "w2v_x.pt")
    return {"work": work, "out": ref, "weights": weights,
            "grads": from_jax_variables({"params": _np(grads)}),
            "w2v_out": np.asarray(jax.jit(w2v.apply)(wvars, jnp.asarray(wx)))}


def test_tp_specs_split_by_head():
    """The port's specs mirror test_tensor_parallel.py:25-33 (torch weights
    are (out, in): JAX's column-parallel kernel is split by rows)."""
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        TransformerEncoder)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        Split, shard_tensor, transformer_tp_shardings)

    model = TransformerEncoder(d_model=64, nhead=4, num_layers=2,
                               dim_feedforward=128)
    sh = transformer_tp_shardings(model, 2)
    assert sh["layers.0.self_attn.in_proj_weight"] == Split(0, 3)
    assert sh["layers.0.self_attn.in_proj_bias"] == Split(0, 3)
    assert sh["layers.0.self_attn.out_proj.weight"] == Split(1)
    assert sh["layers.0.self_attn.out_proj.bias"] is None
    assert sh["layers.0.linear1.weight"] == Split(0)
    assert sh["layers.0.linear1.bias"] == Split(0)
    assert sh["layers.0.linear2.weight"] == Split(1)
    assert sh["layers.0.linear2.bias"] is None
    assert sh["layers.0.norm1.weight"] is None
    # 4 heads do not divide by 3; 128 does not either: replicated whole
    assert not any(transformer_tp_shardings(model, 3).values())
    # rank 1's rows: heads 2 and 3 of q, then of k, then of v
    w = torch.arange(3 * 64.0)[:, None].expand(-1, 64)
    got = shard_tensor(w, Split(0, 3), 1, 2)[:, 0]
    want = torch.cat([torch.arange(32.0, 64.0), torch.arange(96.0, 128.0),
                      torch.arange(160.0, 192.0)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_encoder_matches_jax(tp_reference, world, tmp_path):
    """tp 2 (world 2) and dp 2 x tp 2 (world 4) against one JAX device."""
    import shutil

    work = tmp_path
    for f in ("encoder_weights.pt", "encoder_x.pt", "w2v_weights.pt",
              "w2v_x.pt"):
        shutil.copy(tp_reference["work"] / f, work / f)
    launch("tp", world, work)
    got = torch.load(work / f"tp_out_{world}.pt", weights_only=False)
    np.testing.assert_allclose(got["out"].numpy(), tp_reference["out"],
                               atol=1e-5, rtol=1e-5)
    assert sorted(got["grads"]) == sorted(tp_reference["grads"])
    for name, ref in tp_reference["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), ref.numpy(),
                                   atol=2e-4, rtol=1e-4, err_msg=name)
    # the global norm of clipping: split leaves summed over the tp group,
    # replicated leaves once
    full_sq = sum(float(g.double().square().sum())
                  for g in got["grads"].values())
    np.testing.assert_allclose(got["norm_sq"], full_sq, rtol=1e-5)
    assert got["splits"]["layers.0.self_attn.in_proj_weight"] == (0, 3)
    assert len(got["splits"]) == 12  # 6 split leaves in each of 2 layers
    # gather_state gives back from_jax_variables' tensors bit for bit
    for name, ref in tp_reference["weights"].items():
        assert torch.equal(got["state_dict"][name], ref), name
    assert any(n.endswith("layers.0.linear1.weight")
               for n in got["w2v_splits"])
    np.testing.assert_allclose(got["w2v_out"].numpy(),
                               tp_reference["w2v_out"], atol=1e-5, rtol=1e-5)
