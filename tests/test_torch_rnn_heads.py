"""The port's sequence layers and heads (models/rnn.py, models/heads.py)
against the JAX package's.

With the same weights carried by io/from_jax.py (strict load):
- GRU and LSTM outputs and final states agree within 1e-5, the tolerance
  of tests/test_layers.py's torch-vs-JAX RNN checks;
- `FeatureSequenceProcessing` with a GRU, an LSTM and the mean over time,
  within 1e-5;
- `MultiHeadModel` over a frozen CNN1D extractor, both models
  deterministic (JAX `train=False`, the port in eval mode): the logits of
  every head within 1e-4, the summed CE within 1e-5 and every head
  gradient within 1e-4 * max|g_JAX| of that tensor, as
  tests/test_torch_train_step.py holds the tri-modal model's; JAX's
  extractor gradients are zero (stop_gradient) and the port's are None.
A port train step (train mode) keeps the frozen extractor in eval mode: its
BatchNorm statistics and weights stay exactly as they were, while the heads
move.  Seeded init fills the RNNs from U(+-1/sqrt(H)) reproducibly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import heads as jheads
from multimodalaggressionrecognition_tpu.models import rnn as jrnn
from multimodalaggressionrecognition_tpu.models.cnn1d import (
    CNN1DExtractor as JaxCNN1DExtractor)
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.steps import (
    _head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import heads, rnn
from multimodalaggressionrecognition_tpu_torch.models.cnn1d import (
    CNN1DExtractor)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics, train_step)
from test_torch_train_step import torch_tree
from test_torch_trimodal import random_variables

B, T, E, H = 3, 7, 12, 20
HEADS = ("LSTM_1_layer", "GRU_1_layer", "Avg")
SAMPLES = 32000  # 3 frames out of the CNN1D trunk: the RNNs recur


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rnn_variables(shapes, seed):
    """random_variables, with the RNN leaves from U(+-0.25), near their
    U(+-1/sqrt(H)) init at these widths (random_variables gives a leaf
    that is not a kernel U(+-0.05))."""
    variables = random_variables(shapes, seed)
    rng = np.random.default_rng(seed + 100)

    def leaf(path, v):
        if path[-1].key in ("kernel_ih", "kernel_hh", "bias_ih", "bias_hh"):
            return rng.uniform(-0.25, 0.25, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _x(shape=(B, T, E), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bridged(jmodule, tmodule, x, seed=1):
    variables = rnn_variables(jax.eval_shape(
        jmodule.init, jax.random.PRNGKey(0), x), seed)
    return variables, load_jax_variables(tmodule, variables).eval()


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_outputs_and_final_states_match_jax(cell):
    x = _x()
    jmod, tmod = ((jrnn.GRU(H), rnn.GRU(E, H)) if cell == "gru"
                  else (jrnn.LSTM(H), rnn.LSTM(E, H)))
    variables, tmod = _bridged(jmod, tmod, x)
    want_out, want_state = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got_out, got_state = tmod(torch.from_numpy(x))
    assert got_out.shape == (B, T, H)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5)
    if cell == "gru":
        got_state, want_state = (got_state,), (want_state,)
    for g, w in zip(got_state, want_state):
        assert g.shape == (B, H)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("cell", ["gru", "lstm", "avg"])
def test_feature_sequence_processing_matches_jax(cell):
    x = _x(seed=2)
    jmod = jheads.FeatureSequenceProcessing(2, H, cell)
    tmod = heads.FeatureSequenceProcessing(2, H, cell, input_size=E)
    variables, tmod = _bridged(jmod, tmod, x, seed=3)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_avg_head_reads_the_feature_width():
    """'avg' takes the feature width E into fc1 whatever the hidden size
    (the audio entry's Avg head is built with 512 over 768-d wav2vec-2
    features)."""
    head = heads.FeatureSequenceProcessing(2, 512, "avg", input_size=E)
    assert head.fc1.in_features == E
    assert head(torch.zeros(2, 5, E)).shape == (2, 2)
    with pytest.raises(ValueError, match="unknown cell"):
        heads.FeatureSequenceProcessing(2, H, "rnn", input_size=E)


def _jax_multihead(hidden=8):
    return jheads.MultiHeadModel(heads={
        "LSTM_1_layer": jheads.FeatureSequenceProcessing(2, hidden, "lstm"),
        "GRU_1_layer": jheads.FeatureSequenceProcessing(2, hidden, "gru"),
        "Avg": jheads.FeatureSequenceProcessing(2, 512, "avg")},
        extractor=JaxCNN1DExtractor(pallas_stem=False), freeze_extractor=True)


def _port_multihead(hidden=8):
    return heads.MultiHeadModel({
        "LSTM_1_layer": heads.FeatureSequenceProcessing(
            2, hidden, "lstm", input_size=512),
        "GRU_1_layer": heads.FeatureSequenceProcessing(
            2, hidden, "gru", input_size=512),
        "Avg": heads.FeatureSequenceProcessing(2, 512, "avg",
                                               input_size=512)},
        CNN1DExtractor())


def _labelled(n=3, seed=4):
    rng = np.random.default_rng(seed)
    mask = np.array([1.0] * (n - 1) + [0.0], np.float32)
    return {"x": (rng.standard_normal((n, SAMPLES)) * 0.1).astype(np.float32),
            "labels": {h: rng.integers(0, 2, n).astype(np.int32)
                       for h in HEADS},
            "label_mask": {h: mask for h in HEADS},
            "sample_mask": np.ones(n, np.float32)}


@pytest.fixture(scope="module")
def multihead():
    """(JAX model, its variables, the port model in eval mode, batch)."""
    b = _labelled()
    jmodel = _jax_multihead()
    variables = rnn_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), b["x"]), seed=5)
    model = load_jax_variables(_port_multihead(), variables).eval()
    return jmodel, variables, model, b


def test_multihead_logits_match_jax(multihead):
    jmodel, variables, model, b = multihead
    want = jax.jit(jmodel.apply)(variables, b["x"])
    with torch.no_grad():
        got = model(torch.from_numpy(b["x"]))
    assert list(got) == list(HEADS)
    for h in HEADS:
        assert got[h].shape == (3, 2) and torch.isfinite(got[h]).all()
        np.testing.assert_allclose(got[h].numpy(), np.asarray(want[h]),
                                   atol=1e-4, err_msg=h)


def test_multihead_loss_and_head_gradients_match_jax(multihead):
    jmodel, variables, model, b = multihead
    specs = {h: JaxLossSpec("ce") for h in HEADS}

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           b["x"], train=False)
        return _head_losses_and_metrics(out, b, specs, 2)[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    model.zero_grad(set_to_none=True)
    tb = torch_tree(b)
    total, _ = head_losses_and_metrics(
        model(tb["x"]), tb, {h: LossSpec("ce") for h in HEADS}, 2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    checked = 0
    for name, p in named.items():
        ref = want[name].numpy()
        if name.startswith("extractor."):
            assert p.grad is None and not p.requires_grad, name
            assert not ref.any(), name  # stop_gradient
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)
        checked += 1
    assert checked == 3 * 4 + 2 * 4  # fc1, fc2 each; 4 RNN tensors each


def test_train_step_keeps_the_frozen_extractor(multihead):
    _, variables, _, b = multihead
    model = load_jax_variables(_port_multihead(), variables)
    ext = model.extractor
    before = {k: v.clone() for k, v in ext.state_dict().items()}
    heads_before = {k: v.clone() for k, v in model.heads.state_dict().items()}
    state = create_train_state(model, OptimizerConfig(learning_rate=1e-3),
                               "cpu")
    set_generator(model, torch.Generator().manual_seed(0))
    tb = torch_tree(b)
    batch = {"modalities": tb["x"], "labels": tb["labels"],
             "label_mask": tb["label_mask"]}
    metrics = train_step(state, batch, {h: LossSpec("ce") for h in HEADS}, 2)
    assert np.isfinite(metrics["total_loss"].item())
    assert model.training and not ext.training  # train() keeps it in eval
    assert all(not m.training for m in ext.modules())
    for k, v in ext.state_dict().items():
        assert torch.equal(v, before[k]), k  # BN statistics and weights
    for p in ext.parameters():
        assert p.grad is None and not p.requires_grad
    assert all(id(p) not in {id(q) for q in ext.parameters()}
               for g in state.optimizer.param_groups for p in g["params"])
    moved = [k for k, v in model.heads.state_dict().items()
             if not torch.equal(v, heads_before[k])]
    assert len(moved) == len(heads_before)


def test_bridge_names_the_heads_and_loads_strict(multihead):
    _, variables, model, _ = multihead
    sd = from_jax_variables(variables)
    assert "heads.GRU_1_layer.sequence_nn.weight_ih_l0" in sd
    assert sd["heads.LSTM_1_layer.sequence_nn.weight_hh_l0"].shape == (32, 8)
    assert sd["heads.GRU_1_layer.sequence_nn.weight_ih_l0"].shape == (24, 512)
    kernel = variables["params"]["heads_GRU_1_layer"]["sequence_nn"][
        "kernel_ih"]
    np.testing.assert_array_equal(
        sd["heads.GRU_1_layer.sequence_nn.weight_ih_l0"].numpy(), kernel.T)
    assert sorted(sd) == sorted(model.state_dict())


def test_seeded_init_fills_the_rnns_reproducibly():
    def make():
        return seeded_init_(heads.MultiHeadModel({
            "LSTM_1_layer": heads.FeatureSequenceProcessing(
                2, H, "lstm", input_size=E),
            "GRU_1_layer": heads.FeatureSequenceProcessing(
                2, H, "gru", input_size=E)}), seed=3)

    torch.manual_seed(0)
    a = make()
    torch.manual_seed(1)  # the global RNG must not matter
    b = make()
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for m in (a.heads.LSTM_1_layer.sequence_nn, a.heads.GRU_1_layer.sequence_nn):
        for p in m.parameters():
            assert p.abs().max() <= H ** -0.5
            assert p.abs().max() > 0.8 * H ** -0.5  # the whole range used
