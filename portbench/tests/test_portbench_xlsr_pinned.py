"""The XLS-R configuration shares code with the cells before it, and moves
nothing they read: the transformer layer's default dropout draws, the
fusion encoder's parameters and, for each earlier cell, its full-size
FLOPs a step, launch plan and bounds and the fingerprints of its weights,
pool and draws at its CPU sizes equal the values pinned before the XLS-R
tower came (`test_portbench_pinned.PINNED`, and the layer's values as the
tree before it gave them).  The new cell's own are pinned beside them."""

import json
import os

import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.models.fusion import (
    EqualSizedTransformerModalitiesFusion)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    TransformerEncoderLayer, seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from portbench import harness, inputs, models
from portbench.tests.test_portbench_pinned import (CARD, PINNED, SEED,
                                                   assert_same, fingerprint)
from portbench.yardstick import flops, launches

CELL = "audiotext_xlsr300m_ft_bf16_b32"
EARLIER = ["trimodal_ft_bf16_b32", "audiotext_train_f32_b32",
           "trimodal_frozen_f32_b32", "trimodal_ft_f32_b32"]
# a layer's output sums in train mode and its generator's next draw, as the
# tree before the XLS-R tower gave them
LAYER = {"post_relu": ({}, -9.54663846641779e-07, 696.6440657192725, 8524749),
         "pre_gelu": ({"activation": "gelu", "norm_first": True},
                      54.70534650608897, 719.8693113513291, 8524749)}
FUSION_NAMES = [
    ("encoder.layers.0.self_attn.in_proj_weight", (2304, 768)),
    ("encoder.layers.0.self_attn.in_proj_bias", (2304,)),
    ("encoder.layers.0.self_attn.out_proj.weight", (768, 768)),
    ("encoder.layers.0.self_attn.out_proj.bias", (768,)),
    ("encoder.layers.0.linear1.weight", (2048, 768)),
    ("encoder.layers.0.linear1.bias", (2048,)),
    ("encoder.layers.0.linear2.weight", (768, 2048)),
    ("encoder.layers.0.linear2.bias", (768,)),
    ("encoder.layers.0.norm1.weight", (768,)),
    ("encoder.layers.0.norm1.bias", (768,)),
    ("encoder.layers.0.norm2.weight", (768,)),
    ("encoder.layers.0.norm2.bias", (768,)),
    ("encoder.norm.weight", (768,)),
    ("encoder.norm.bias", (768,))]
NEW = {
    "flops_per_step": 34471368250368.0,
    "expected_counts": {"framed_conv1d": 1},
    "bounds_s": {"framed_conv1d": 0.0006321173397014925},
    "tiny": {
        "pool": {"layout": "9ddb3dfc70234fe4", "elements": 354384,
                 "abs": 51579733.79660232, "signed": 163047.76035308925},
        "alpha": [0.5, 0.5],
        "weights": {"layout": "7c2c71b94671872c", "elements": 6352224,
                    "abs": 439523982.99662197, "signed": 10761535.74034101},
        # the draws' uniforms (a time mask's rate is None)
        "draws": {"layout": "097e5e3ad0d031cd", "elements": 3850908,
                  "abs": 2469588090.5382605, "signed": 2469588090.5382605}}}
PINS = {**{c: PINNED[c] for c in EARLIER}, CELL: NEW}


@pytest.mark.parametrize("kind", sorted(LAYER))
def test_the_layers_default_draws_are_unchanged(kind):
    kw, signed, total, next_draw = LAYER[kind]
    layer = seeded_init_(TransformerEncoderLayer(32, 4, 64, 0.1, **kw),
                         0).train()
    set_generator(layer, torch.Generator().manual_seed(1))
    x = torch.randn(3, 9, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y = layer(x).double()
    assert float(y.sum()) == pytest.approx(signed, abs=1e-9 * total)
    assert float(y.abs().sum()) == pytest.approx(total, rel=1e-9)
    draw = torch.rand(1, generator=layer.dropout.generator)
    assert int(draw.mul(2 ** 24).item()) == next_draw


def test_the_fusion_encoders_parameters_are_unchanged():
    fusion = EqualSizedTransformerModalitiesFusion(1, 768, 8)
    assert [(n, tuple(t.shape)) for n, t in fusion.state_dict().items()] \
        == FUSION_NAMES


@pytest.mark.parametrize("cell", sorted(PINS))
def test_full_size_flops_plan_and_bounds(cell):
    _, cfg, job, _, _ = harness.load_cell(cell)
    pinned = PINS[cell]
    counts = launches.expected_counts(cfg, job)
    assert counts == pinned["expected_counts"]
    for key in counts:
        assert launches.bound_per_step(CARD, cfg, job, key) == pytest.approx(
            pinned["bounds_s"][key], rel=1e-12)
    assert flops.step_flops({**cfg, "focal_alpha": (0.5, 0.5)}, job) == \
        pinned["flops_per_step"]


def uniforms(draws):
    return {k: u for k, (u, _) in draws.items()}


@pytest.mark.parametrize("cell", sorted(PINS))
def test_tiny_weights_pool_and_draws(cell):
    _, cfg, job, _, _ = harness.load_cell(cell)
    model = models.load(cfg)
    cfg = {**cfg, **model.TINY["config"]}
    job = {**job, **model.TINY["job"]}
    mods, heads = model.modalities(cfg, job), model.heads(cfg, job)
    pinned = PINS[cell]["tiny"]
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
    if cell == CELL:
        draws = [uniforms(d) for d in draws]
    assert_same(fingerprint(draws), pinned["draws"])


def test_the_earlier_cells_are_the_manifests_first():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    assert cells == EARLIER + [CELL]
