"""What a cell reads may not move when the harness is reworked: each cell's
full-size FLOPs a step (counted on the meta device), launch plan and
bounds, and a fingerprint of its weights, pool and dropout draws at its
model's CPU sizes and the tests' seed, all pinned from the harness before
models came from their own modules."""

import hashlib
import json
import os

import pytest
import torch

from portbench import harness, inputs, models
from portbench.yardstick import flops, launches

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CARD = "NVIDIA H100 80GB HBM3"
SEED = 3_000_000_019
# a fingerprint's sums may differ in rounding where the CPU draws normals
# with other instructions; a draw that moved differs by far more
REL = 1e-6
PINNED = {
 "trimodal_ft_bf16_b32": {
  "flops_per_step": 15843587751936.0,
  "expected_counts": {
   "framed_conv1d": 1,
   "window_attention.bf16": 12,
   "window_attention_bwd.bf16": 12,
   "roll.bf16": 8
  },
  "bounds_s": {
   "framed_conv1d": 7.962364179104478e-06,
   "window_attention.bf16": 0.001809672367761194,
   "window_attention_bwd.bf16": 0.0031465094495522388,
   "roll.bf16": 0.0011042913814925373
  },
  "tiny": {
   "weights": {
    "layout": "59ac77a578249931",
    "elements": 36338346,
    "abs": 6299592559.534822,
    "signed": 132656648.88820857
   },
   "pool": {
    "layout": "8703b1da47723532",
    "elements": 1140864,
    "abs": 578838709.5291364,
    "signed": 511922298.20416546
   },
   "draws": {
    "layout": "6dffe6217e02f499",
    "elements": 546783,
    "abs": 1319481776.7218301,
    "signed": 1319481776.7218301
   },
   "alpha": [
    0.25,
    0.75
   ]
  }
 },
 "audiotext_train_f32_b32": {
  "flops_per_step": 71744476160.0,
  "expected_counts": {
   "framed_conv1d": 1
  },
  "bounds_s": {
   "framed_conv1d": 7.962364179104478e-06
  },
  "tiny": {
   "weights": {
    "layout": "48a82cffda3a3323",
    "elements": 8071360,
    "abs": 478224653.3553667,
    "signed": 16678896.103428029
   },
   "pool": {
    "layout": "9ddb3dfc70234fe4",
    "elements": 354384,
    "abs": 51579733.79660232,
    "signed": 163047.76035308925
   },
   "draws": {
    "layout": "317ea16730571b16",
    "elements": 448122,
    "abs": 534064312.0829009,
    "signed": 534064312.0829009
   },
   "alpha": [
    0.5,
    0.5
   ]
  }
 },
 "trimodal_frozen_f32_b32": {
  "flops_per_step": 5350999425024.0,
  "expected_counts": {
   "framed_conv1d": 1,
   "window_attention": 12,
   "roll": 4
  },
  "bounds_s": {
   "framed_conv1d": 7.962364179104478e-06,
   "window_attention": 0.0035585445444776117,
   "roll": 0.0011042913814925373
  },
  "tiny": {
   "weights": {
    "layout": "59ac77a578249931",
    "elements": 36338346,
    "abs": 6299592559.534822,
    "signed": 132656648.88820857
   },
   "pool": {
    "layout": "8703b1da47723532",
    "elements": 1140864,
    "abs": 578838709.5291364,
    "signed": 511922298.20416546
   },
   "draws": {
    "layout": "2bdcb426aa4e22f2",
    "elements": 546189,
    "abs": 705140424.304468,
    "signed": 705140424.304468
   },
   "alpha": [
    0.25,
    0.75
   ]
  }
 },
 "trimodal_ft_f32_b32": {
  "flops_per_step": 15843587751936.0,
  "expected_counts": {
   "framed_conv1d": 1,
   "window_attention": 24,
   "window_attention_bwd": 12,
   "roll": 12
  },
  "bounds_s": {
   "framed_conv1d": 7.962364179104478e-06,
   "window_attention": 0.007172608840597015,
   "window_attention_bwd": 0.008722647037221167,
   "roll": 0.0033128741444776117
  },
  "tiny": {
   "weights": {
    "layout": "59ac77a578249931",
    "elements": 36338346,
    "abs": 6299592559.534822,
    "signed": 132656648.88820857
   },
   "pool": {
    "layout": "8703b1da47723532",
    "elements": 1140864,
    "abs": 578838709.5291364,
    "signed": 511922298.20416546
   },
   "draws": {
    "layout": "6dffe6217e02f499",
    "elements": 546783,
    "abs": 1319481776.7218301,
    "signed": 1319481776.7218301
   },
   "alpha": [
    0.25,
    0.75
   ]
  }
 }
}


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def leaves(tree, prefix=""):
    """[(path, tensor)] of a tree of dicts, tuples, lists and numbers, dicts
    in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                        f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves(v,
                                                              f"{prefix}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [(prefix, torch.tensor(float(tree)))]


def fingerprint(tree):
    """The leaves' paths, shapes and dtypes (hashed), their element count,
    and two sums weighted by place (in the leaf and among the leaves): of
    the magnitudes and of the values."""
    items = leaves(tree)
    s_abs = s_signed = 0.0
    for i, (_, t) in enumerate(items):
        x = t.detach().double().flatten()
        w = torch.arange(x.numel(), dtype=torch.float64) % 101 + 1
        s_abs += (i + 1) * float((x.abs() * w).sum())
        s_signed += (i + 1) * float((x * w).sum())
    layout = hashlib.sha256("|".join(
        f"{name}:{tuple(t.shape)}:{t.dtype}" for name, t in items
    ).encode()).hexdigest()[:16]
    return {"layout": layout, "elements": sum(t.numel() for _, t in items),
            "abs": s_abs, "signed": s_signed}


def assert_same(got, pinned):
    assert got["layout"] == pinned["layout"]
    assert got["elements"] == pinned["elements"]
    assert got["abs"] == pytest.approx(pinned["abs"], rel=REL)
    assert abs(got["signed"] - pinned["signed"]) <= REL * pinned["abs"]


@pytest.mark.parametrize("cell", cells())
def test_full_size_flops_plan_and_bounds(cell):
    _, cfg, job, _, _ = harness.load_cell(cell)
    pinned = PINNED[cell]
    counts = launches.expected_counts(cfg, job)
    assert counts == pinned["expected_counts"]
    for key in counts:
        assert launches.bound_per_step(CARD, cfg, job, key) == pytest.approx(
            pinned["bounds_s"][key], rel=1e-12)
    # the loss's class weights do not change the count
    assert flops.step_flops({**cfg, "focal_alpha": (0.5, 0.5)}, job) == \
        pinned["flops_per_step"]


@pytest.mark.parametrize("cell", cells())
def test_tiny_weights_pool_and_draws(cell):
    """As `harness.run` makes them, at the model's `TINY` sizes."""
    _, cfg, job, _, _ = harness.load_cell(cell)
    model = models.load(cfg)
    cfg = {**cfg, **model.TINY["config"]}
    job = {**job, **model.TINY["job"]}
    mods, heads = model.modalities(cfg, job), model.heads(cfg, job)
    pinned = PINNED[cell]["tiny"]
    pool = inputs.make_pool(
        SEED, job["pool_batches"], "cpu",
        lambda g: model.make_batch(g, cfg, mods, job["batch_size"], heads,
                                   "cpu"))
    assert_same(fingerprint(pool), pinned["pool"])
    cfg.update(model.pool_config(pool, heads))
    assert list(cfg["focal_alpha"]) == pinned["alpha"]
    weights = inputs.make_weights(model.parameter_spec(cfg, mods), SEED, "cpu")
    assert_same(fingerprint(weights), pinned["weights"])
    g = inputs.draws_generator(SEED, "cpu")
    draws = [model.draw_masks(g, cfg, job, mods, "cpu")
             for _ in range(job["check_steps"])]
    assert_same(fingerprint(draws), pinned["draws"])
