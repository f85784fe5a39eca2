"""GigaChat3.1's decoder as the text tower of the audio,text model
(`cli/train_multimodal --text_extractor gigachat3_1`, models/gigachat.py)
against its plain reference (portbench/reference/gigachat.py), at the
benchmark model's CPU sizes (portbench/models/physverb_gigachat.py `TINY`:
hidden 64, 4 heads, 16 experts in 4 groups over 4 shares, top-4, one dense
and two MoE layers, transcripts of up to 32 ids) on seeded random weights
and token-id batches of 4 clips.

Tolerances:

- float32: both sides compute the same function and take the same routing
  (checked equal), and only the summation order of the library kernels
  differs (the reference runs the tower in blocks of two clips, its experts
  by mask, its attention as an explicit masked softmax), so the features,
  logits and loss are held to 1e-5 relative and each first gradient to
  1e-5 of its leaf's largest element (the CNN1D audio tower's to 1e-4: its
  train-mode batch norm over four clips cancels digits in the backward, and
  its convs' biases before the norm have a gradient nought but for
  rounding, so they are left out); after three Adam steps on text alone
  each leaf's change to 1e-3 by its norm (Adam divides by the root of the
  second moment, so an element whose gradient is nearly nought moves by
  about the lr whatever rounding gave it: `kv_b_proj` reads 1.8e-4).  The reference with TF32 products misses
  1e-5.
- bfloat16, against the reference's bf16 products: the two round at
  different places (the program's kernels in bf16 per op, the reference
  once per stored activation, its weights' gradients per block), and at 64
  wide a rounding moves a norm weight's gradient by tens of percent.  The
  bounds sit between what the program reads (seed 3000000019: features
  1.0e-2, the worst leaf's first-gradient norm gap 0.23, routing agreement
  99.6 %; over six seeds at most 1.9e-2, 0.52, at least 98.7 %) and what
  the reference with fp8 products reads (features 0.10, gap 17.5,
  agreement 95.0 %): features 3e-2, gap 2.0, agreement 99 %.
"""

import dataclasses
import json
import math
import os
import statistics

import pytest
import torch
from torch.func import functional_call

from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
    MultimodalConfig, build_model)
from multimodalaggressionrecognition_tpu_torch.models import gigachat as PG
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, train_step)
from multimodalaggressionrecognition_tpu_torch.utils.precision import (
    cast_floating)
from portbench import inputs
from portbench.models import physverb_gigachat as GM
from portbench.reference import gigachat as G
from portbench.reference import model as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = ("audio", "text")
SEED = 3_000_000_019
LR = 1e-5
SPECS = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
         "verb": LossSpec("ce")}
AUDIO = "extractors.audio."
CNN1D = AUDIO + "extractor.conv"


def full_cfg():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "audiotext_gigachat31_ep32.json")) as f:
        return json.load(f)


def tiny_cfg():
    return {**full_cfg(), **GM.TINY["config"], "focal_alpha": (0.5, 0.5)}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(4)
    cfg = tiny_cfg()
    weights = inputs.make_weights(G.parameter_spec(cfg, MODS), SEED, "cpu")
    g = torch.Generator().manual_seed(inputs.subseed(SEED, inputs.BATCHES))
    batches = [GM.make_batch(g, cfg, MODS, 4, ("verb",), "cpu")
               for _ in range(3)]
    return cfg, weights, batches


def port_model(cfg, weights):
    mcfg = MultimodalConfig(text_extractor="gigachat3_1",
                            audio_samples=cfg["audio_samples"],
                            text_tokens=cfg["text_tokens"], device="cpu")
    model = build_model(mcfg, MODS, text_config=GM.port_config(cfg))
    model.load_state_dict(weights, strict=True)
    return model


def rel(a, b):
    return float((a - b).norm() / b.norm())


def text_of(batch):
    t = batch["modalities"]["text"]
    return t["data"], t["lengths"]


def port_routes(tower, run):
    """The expert ids each MoE layer's router chose during `run()`."""
    seen = []
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda m, a, out: seen.append(out[0]))
        for layer in tower.model.layers if layer.moe]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def reference_routes(run, monkeypatch):
    seen = []
    route = G.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(G, "route", recorded)
    out = run()
    monkeypatch.setattr(G, "route", route)
    return out, seen


def agreement(a, b, valid):
    """The share of the program's valid tokens' chosen experts that the
    reference chose too."""
    hit = total = 0
    rows = valid.reshape(-1).nonzero().squeeze(1).tolist()
    for x, y in zip(a, b):
        for t in rows:
            sx, sy = set(x[t].tolist()), set(y[t].tolist())
            hit, total = hit + len(sx & sy), total + len(sx)
    return hit / total


def valid_of(batch):
    ids, lengths = text_of(batch)
    return torch.arange(ids.shape[1])[None] < lengths[:, None]


def held_part(moe, x, valid, held_experts):
    """The held experts' part of MoE layer `moe` on its own routing, through
    `held_experts` (`held_experts_grouped` or `held_experts_loop`)."""
    flat = x.reshape(-1, x.shape[-1])
    ids, w = moe.gate(flat)
    key = PG.held_keys(ids, valid.reshape(-1), moe.cfg.first_expert,
                       moe.cfg.experts_held)
    order, counts, keep, ws = PG.sort_assignments(key, w,
                                                  moe.cfg.experts_held,
                                                  x.dtype)
    return held_experts(flat, order, counts, keep, ws,
                        moe.experts.gate_up_proj, moe.experts.down_proj)


def grouped_and_loop(moe, x, valid):
    """{path: [held part, dx, each of the layer's gradients]} through the
    grouped products and through the loop."""
    got = {}
    for name, fn in (("loop", PG.held_experts_loop),
                     ("grouped", PG.held_experts_grouped)):
        moe.zero_grad()
        xi = x.clone().requires_grad_(True)
        out = held_part(moe, xi, valid, fn)
        out.float().square().sum().backward()
        got[name] = [out, xi.grad] + [p.grad for p in moe.parameters()]
    return got


# ---------------------------------------------------------------- pieces
def test_yarn_frequencies_and_softmax_scale_by_hand():
    cfg = PG.GIGACHAT3_1
    # correction dims at 4096 positions, theta 1e5, d 64: beta 32 ->
    # 64 ln(4096 / 64 pi) / (2 ln 1e5) = 8.378 (floor 8), beta 1 -> 18.01
    # (ceil 19); pairs below 8 keep theta^(-2i/64), above 19 take it / 64
    inv = PG.yarn_inv_freq(cfg)
    assert inv == pytest.approx(G.yarn_inv_freq(full_cfg()), rel=1e-14)
    for i in (0, 1, 7):
        assert inv[i] == pytest.approx(1e5 ** (-2 * i / 64), rel=1e-12)
    for i in (19, 25, 31):
        assert inv[i] == pytest.approx(1e5 ** (-2 * i / 64) / 64, rel=1e-12)
    ramp = 5 / 11  # pair 13: (13 - 8) / (19 - 8)
    want = 1e5 ** (-26 / 64) * (ramp / 64 + (1 - ramp))
    assert inv[13] == pytest.approx(want, rel=1e-12)
    # 192^-1/2 (0.1 ln 64 + 1)^2 = 0.07216878 * 1.4158883^2
    assert PG.softmax_scale(cfg) == pytest.approx(0.1446796, rel=1e-6)
    assert G.attention_scale(full_cfg()) == PG.softmax_scale(cfg)
    cos, sin = PG.rope_tables(cfg, 256, "cpu")
    assert cos.shape == (256, 64)
    assert float(cos[5, 3]) == pytest.approx(math.cos(5 * inv[3]), abs=1e-7)
    assert float(sin[200, 40]) == pytest.approx(math.sin(200 * inv[8]),
                                                abs=1e-6)


def test_rope_deinterleaves_the_pairs():
    x = torch.arange(8.0).reshape(1, 1, 1, 8)
    cos, sin = torch.ones(1, 8), torch.zeros(1, 8)
    assert PG.apply_rope(x, cos, sin).flatten().tolist() == [
        0, 2, 4, 6, 1, 3, 5, 7]
    cos, sin = torch.zeros(1, 8), torch.ones(1, 8)
    assert PG.apply_rope(x, cos, sin).flatten().tolist() == [
        -1, -3, -5, -7, 0, 2, 4, 6]


def test_group_limited_topk_against_a_direct_formula():
    cfg = GM.port_config(tiny_cfg())
    g = torch.Generator().manual_seed(3)
    x = torch.randn(40, cfg.hidden_size, generator=g)
    n = cfg.router_experts
    weight = torch.randn(n, cfg.hidden_size, generator=g) * 0.2
    bias = torch.randn(n, generator=g) * 0.1
    ids, w = PG.route(x, weight, bias, cfg)
    per = n // cfg.n_group
    for t in range(x.shape[0]):
        s = [1 / (1 + math.exp(-float(x[t] @ weight[e]))) for e in range(n)]
        c = [s[e] + float(bias[e]) for e in range(n)]
        groups = [sum(sorted(c[j * per:(j + 1) * per])[-2:])
                  for j in range(cfg.n_group)]
        kept = sorted(range(cfg.n_group), key=lambda j: -groups[j])[
            :cfg.topk_group]
        masked = [c[e] if e // per in kept else 0.0 for e in range(n)]
        chosen = sorted(range(n), key=lambda e: -masked[e])[
            :cfg.num_experts_per_tok]
        assert sorted(ids[t].tolist()) == sorted(chosen)
        total = sum(s[e] for e in chosen) + 1e-20
        for e, got in zip(ids[t].tolist(), w[t].tolist()):
            assert got == pytest.approx(
                s[e] / total * cfg.routed_scaling_factor, rel=1e-5)


def moe_layer(cfg, parallel, rank, seed=5):
    """A MoE block of the `rank`-th of `parallel` shares of `cfg`'s routed
    experts, on weights drawn for every expert: the share's slice of
    them."""
    g = torch.Generator().manual_seed(seed)
    n, e, i = cfg.router_experts, cfg.hidden_size, cfg.moe_intermediate_size
    gate_up = torch.randn(n, 2 * i, e, generator=g) * e ** -0.5
    down = torch.randn(n, e, i, generator=g) * i ** -0.5
    router = torch.randn(n, e, generator=g) * 0.3
    bias = torch.randn(n, generator=g) * 0.05
    shared = [torch.randn(i, e, generator=g) * e ** -0.5,
              torch.randn(i, e, generator=g) * e ** -0.5,
              torch.randn(e, i, generator=g) * i ** -0.5]
    part = dataclasses.replace(cfg, n_routed_experts=n // parallel,
                               expert_parallel=parallel, expert_rank=rank)
    moe = PG.MoE(part)
    held = slice(part.first_expert, part.first_expert + part.experts_held)
    with torch.no_grad():
        moe.gate.weight.copy_(router)
        moe.gate.e_score_correction_bias.copy_(bias)
        moe.experts.gate_up_proj.copy_(gate_up[held])
        moe.experts.down_proj.copy_(down[held])
        for lin, w in zip((moe.shared_experts.gate_proj,
                           moe.shared_experts.up_proj,
                           moe.shared_experts.down_proj), shared):
            lin.weight.copy_(w)
    return moe


def test_the_shares_routed_parts_add_up_to_the_uncut_layer():
    """16 experts over 4 shares: each share routes over all 16 and adds its
    own 4 experts' part; the four parts plus the shared expert (counted
    once) are the uncut layer."""
    cfg = GM.port_config(tiny_cfg())
    x = torch.randn(3, 7, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(8))
    valid = torch.ones(3, 7, dtype=torch.bool)
    whole = moe_layer(cfg, 1, 0)
    with torch.no_grad():
        want = whole(x, valid)
        shared = whole.shared_experts(x)
        parts = [moe_layer(cfg, 4, r)(x, valid) - shared
                 for r in range(4)]
    assert rel(sum(parts) + shared, want) < 1e-6
    assert all(float(p.abs().max()) > 0 for p in parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_products_equal_the_loop(dtype):
    cfg = GM.port_config(tiny_cfg())
    torch.manual_seed(0)
    moe = moe_layer(cfg, 4, 1).to(dtype)
    x = torch.randn(4, 9, cfg.hidden_size).to(dtype)
    valid = torch.arange(9)[None] < torch.tensor([9, 3, 6, 1])[:, None]
    got = grouped_and_loop(moe, x, valid)
    for a, b in zip(got["loop"], got["grouped"]):
        if a is not None or b is not None:
            assert torch.equal(a, b)
    assert got["grouped"][0].abs().max() > 0
    ids, _ = moe.gate(x.reshape(-1, cfg.hidden_size))
    key = PG.held_keys(ids, valid.reshape(-1), moe.cfg.first_expert,
                       moe.cfg.experts_held)
    counts = torch.bincount(key, minlength=5)[:4]
    with torch.no_grad():
        moe(x, valid)
        moe(x, valid)
    assert int(counts.sum()) > 0 and torch.equal(moe.rows, 2 * counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_past_the_last_offset_are_never_read(dtype, monkeypatch):
    """A grouped product leaves what it likes in the rows of no held expert
    (the card's leaves garbage there): with NaN written there, the grouped
    path still equals the loop bit for bit, gradients included."""
    grouped_mm = torch._grouped_mm

    def dirty(a, b, offs):
        out = grouped_mm(a, b, offs=offs)
        out[int(offs[-1]):] = float("nan")
        return out

    monkeypatch.setattr(torch, "_grouped_mm", dirty)
    cfg = GM.port_config(tiny_cfg())
    moe = moe_layer(cfg, 4, 2).to(dtype)
    x = torch.randn(3, 8, cfg.hidden_size).to(dtype)
    valid = torch.arange(8)[None] < torch.tensor([8, 5, 2])[:, None]
    got = grouped_and_loop(moe, x, valid)
    for a, b in zip(got["loop"], got["grouped"]):
        if a is not None or b is not None:
            assert torch.equal(a, b)


def test_pads_are_never_routed():
    cfg = GM.port_config(tiny_cfg())
    moe = moe_layer(cfg, 1, 0)
    x = torch.randn(2, 6, cfg.hidden_size)
    lengths = torch.tensor([6, 2])
    valid = torch.arange(6)[None] < lengths[:, None]
    with torch.no_grad():
        out = moe(x, valid)
        shared = moe.shared_experts(x)
    assert int(moe.rows.sum()) == 8 * cfg.num_experts_per_tok
    assert torch.equal(out[1, 2:], shared[1, 2:])
    assert not torch.equal(out[1, :2], shared[1, :2])
    ids, w = moe.gate(x.reshape(-1, cfg.hidden_size))
    key = PG.held_keys(ids, valid.reshape(-1), 0, moe.cfg.experts_held)
    assert (key.view(12, -1)[valid.reshape(-1)] < 16).all()
    assert (key.view(12, -1)[~valid.reshape(-1)] == 16).all()


def test_pad_features_are_zero_and_valid_ones_not(setup):
    cfg, weights, batches = setup
    model = port_model(cfg, weights)
    ids, lengths = text_of(batches[0])
    with torch.no_grad():
        feats = model.extractors["text"](ids, lengths)
    valid = valid_of(batches[0])
    assert (feats[~valid] == 0).all()
    assert (feats[valid].abs().sum(-1) > 0).all()


# ---------------------------------------------------------------- float32
def test_forward_features_logits_and_routing_match_the_reference(
        setup, monkeypatch):
    cfg, weights, batches = setup
    model = port_model(cfg, weights).train()
    mods = batches[0]["modalities"]
    ids, lengths = text_of(batches[0])
    tower = model.extractors["text"]
    with torch.no_grad():
        feats, got = port_routes(tower, lambda: tower(ids, lengths))
        ref, want = reference_routes(lambda: G.tower(
            ids, lengths, weights, cfg, M.Products(None)), monkeypatch)
    assert feats.shape == (4, cfg["text_tokens"], 768)
    assert rel(feats, ref) < 1e-5
    assert len(got) == len(want) == 2
    assert agreement(got, want, valid_of(batches[0])) == 1.0

    set_generator(model, torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits = model(mods)
    masks = G.draw_masks(torch.Generator().manual_seed(6), cfg, MODS, 4,
                         "cpu")
    prod = M.Products(None)
    out = M.heads_logits(
        {"audio": M.audio_tower(mods["audio"]["data"], weights, masks, prod),
         "text": ref}, weights, G.flagship(cfg), masks, prod)
    for head in ("phys", "verb"):
        assert rel(logits[head], out[head]) < 1e-5, head


def test_tf32_products_miss_the_float32_tolerance(setup):
    cfg, weights, batches = setup
    ids, lengths = text_of(batches[0])
    with torch.no_grad():
        f32 = G.tower(ids, lengths, weights, cfg, M.Products(None))
        tf32 = G.tower(ids, lengths, weights, cfg, M.Products("tf32"))
    assert rel(tf32, f32) > 1e-4


def train(cfg, weights, batches, steps, compute_dtype=None, lr=LR):
    model = port_model(cfg, weights)
    state = create_train_state(model, OptimizerConfig(lr), "cpu")
    set_generator(state.model, torch.Generator().manual_seed(7))
    out = [train_step(state, batches[i], SPECS, 2, compute_dtype)
           for i in range(steps)]
    return state, out


def test_loss_and_first_gradients_match_the_reference(setup):
    cfg, weights, batches = setup
    state, (metrics,) = train(cfg, weights, batches, 1)
    ref = G.GigaChatReferenceTrainer(weights, cfg, MODS, lr=LR)
    masks = G.draw_masks(torch.Generator().manual_seed(7), cfg, MODS, 4,
                         "cpu")
    loss, grads = ref.loss_and_grads(batches[0], masks)
    assert float(metrics["total_loss"]) == pytest.approx(float(loss),
                                                         rel=1e-5)
    params = dict(state.model.named_parameters())
    trained = [n for n, p in params.items() if p.requires_grad]
    assert sorted(trained) == sorted(GM.trainable_names(cfg, {}, MODS))
    assert set(grads) == set(trained)
    for n in trained:
        if n.startswith(CNN1D) and n.endswith(".bias"):
            continue  # a conv's bias before batch norm: nought gradient
        g = grads[n]
        tol = 1e-4 if n.startswith(AUDIO) else 1e-5
        assert (params[n].grad - g).abs().max() <= tol * g.abs().max(), n
    for leaf in ("layers.1.mlp.gate.weight",
                 "layers.1.mlp.experts.gate_up_proj",
                 "layers.2.mlp.experts.down_proj",
                 "layers.0.mlp.up_proj.weight"):
        assert grads[f"{G.DEC}.{leaf}"].abs().max() > 0, leaf
    embedding = f"{G.DEC}.embed_tokens.weight"
    assert embedding not in grads and params[embedding].grad is None


def test_three_adam_steps_match_the_reference(setup):
    """Text alone (the audio rows marked absent), at lr 1e-3.  With the
    CNN1D in the step, its batch norm over four clips and its max pools
    turn the first step's rounding into gradients a few percent apart by
    the third (the flagship's own cell reads change gaps of 2e-2, PERF.md
    section 4); and at the cell's 1e-5 a change is a few hundred float32
    ulps of its parameter, whose rounding would be the reading."""
    cfg, weights, batches = setup
    batches = [inputs.tree_map(torch.clone, b) for b in batches]
    for b in batches:
        b["modalities"]["audio"]["present"].zero_()
    state, _ = train(cfg, weights, batches, 3, lr=1e-3)
    ref = G.GigaChatReferenceTrainer(weights, cfg, MODS, lr=1e-3)
    g = torch.Generator().manual_seed(7)
    for b in batches:
        ref.step(b, G.draw_masks(g, cfg, MODS, 4, "cpu"))
    params = dict(state.model.named_parameters())
    for n in ref.trainable:
        p, r = params[n].detach() - weights[n], ref.params[n] - weights[n]
        assert torch.equal(p, r) or rel(p, r) <= 1e-3, n
    assert all(torch.equal(params[n], weights[n]) for n in ref.trainable
               if n.startswith(AUDIO + "extractor."))
    embedding = f"{G.DEC}.embed_tokens.weight"
    assert embedding not in ref.trainable
    assert torch.equal(params[embedding], weights[embedding])
    buffers = dict(state.model.named_buffers())
    biases = [n for n in buffers if n.endswith(G.BIAS)]
    assert len(biases) == 2
    assert all(torch.equal(buffers[n], weights[n]) for n in biases)


def test_the_correction_bias_has_no_gradient_and_no_optimizer_state(setup):
    cfg, weights, batches = setup
    state, _ = train(cfg, weights, batches, 1)
    names = {n for n, _ in state.model.named_parameters()}
    assert not any(n.endswith(G.BIAS) for n in names)
    optimized = {id(p) for p in state.optimizer.params}
    buffers = [b for n, b in state.model.named_buffers()
               if n.endswith(G.BIAS)]
    assert buffers and not any(id(b) in optimized for b in buffers)


# ---------------------------------------------------------------- bfloat16
def bf16_readings(cfg, weights, batch, products, monkeypatch):
    """(features, routes, loss, first gradients) of the reference at
    `products`."""
    ids, lengths = text_of(batch)
    with torch.no_grad():
        feats, routes = reference_routes(lambda: G.tower(
            ids, lengths, weights, cfg, M.Products(products)), monkeypatch)
    ref = G.GigaChatReferenceTrainer(weights, cfg, MODS, lr=LR,
                                     products=products)
    masks = G.draw_masks(torch.Generator().manual_seed(7), cfg, MODS, 4,
                         "cpu")
    loss, grads = ref.loss_and_grads(batch, masks)
    return feats, routes, float(loss), grads


def worst_norm_gap(got, want):
    """The harness's gradient check: the worst leaf's norm gap over
    max(its reference norm, the median leaf's)."""
    norms = {n: float(g.norm()) for n, g in want.items()}
    median = statistics.median(norms.values())
    return max(abs(float(got[n].norm()) - norms[n]) / max(norms[n], median)
               for n in want)


def test_bf16_step_matches_the_bf16_reference_and_fp8_does_not(
        setup, monkeypatch):
    cfg, weights, batches = setup
    batch = batches[0]
    model = port_model(cfg, weights)
    tower = model.extractors["text"]
    ids, lengths = text_of(batch)
    with torch.no_grad():
        params = cast_floating(dict(tower.named_parameters()), torch.bfloat16)
        feats, routes = port_routes(tower, lambda: functional_call(
            tower, params, (ids, lengths)))
    assert feats.dtype == torch.bfloat16
    state, (metrics,) = train(cfg, weights, batches, 1, "bfloat16")
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.requires_grad}
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    valid = valid_of(batch)
    want = bf16_readings(cfg, weights, batch, "bf16", monkeypatch)
    assert rel(feats.float(), want[0]) < 3e-2
    assert agreement(routes, want[1], valid) >= 0.99
    assert float(metrics["total_loss"]) == pytest.approx(want[2], rel=2e-2)
    assert worst_norm_gap(grads, want[3]) < 2.0
    fp8 = bf16_readings(cfg, weights, batch, "fp8", monkeypatch)
    assert rel(fp8[0], want[0]) > 3e-2
    assert agreement(fp8[1], want[1], valid) < 0.99
    assert worst_norm_gap(fp8[3], want[3]) > 2.0


# ---------------------------------------------------------------- the entry
def test_the_flag_builds_the_published_share():
    cfg = parse_config(MultimodalConfig, [
        "--modalities", "audio,text", "--text_extractor", "gigachat3_1",
        "--text_tokens", "256"])
    with torch.device("meta"):
        model = build_model(cfg, MODS)
    assert model.feature_shapes["text"] == (256, 768)
    tower = model.extractors["text"]
    assert GM.port_config(full_cfg()) == PG.GIGACHAT3_1_EP32
    assert tower.model.cfg == PG.GIGACHAT3_1_EP32
    layers = tower.model.layers
    assert len(layers) == 5 and [l.moe for l in layers] == [False] + [True] * 4
    a = layers[0].self_attn
    assert a.q_b_proj.weight.shape == (64 * 192, 1536)
    assert a.kv_a_proj_with_mqa.weight.shape == (576, 7168)
    assert a.kv_b_proj.weight.shape == (64 * 320, 512)
    assert a.o_proj.weight.shape == (7168, 64 * 192)
    moe = layers[1].mlp
    assert moe.gate.weight.shape == (256, 7168)
    assert moe.experts.gate_up_proj.shape == (8, 4096, 7168)
    assert moe.experts.down_proj.shape == (8, 7168, 2048)
    assert PG.GIGACHAT3_1_EP32.first_expert == 0
    assert tower.model.embed_tokens.weight.shape == (128256, 7168)
    assert not tower.model.embed_tokens.weight.requires_grad
    counts = {n: p.numel() for n, p in tower.named_parameters()}
    assert sum(counts.values()) == 3_576_979_200
    assert sum(counts.values()) - counts["adaptor.weight"] - counts[
        "adaptor.bias"] == 3_571_473_408
    assert sum(p.numel() for p in tower.parameters()
               if p.requires_grad) == 2_657_640_192
    assert sorted(n for n, p in model.named_parameters()
                  if p.requires_grad) == sorted(
        n for n, _, _ in G.parameter_spec(full_cfg(), MODS)
        if G.is_trainable(n))
    assert sorted(n for n, _ in model.named_buffers() if "text" in n) == [
        f"{G.DEC}.layers.{i}.mlp.gate.{G.BIAS}" for i in range(1, 5)]


def test_the_default_text_tower_is_unchanged():
    cfg = parse_config(MultimodalConfig, ["--modalities", "audio,text"])
    assert cfg.text_extractor == "identity"
    with pytest.raises(SystemExit):
        build_model(dataclasses.replace(cfg, text_extractor="rubert"), MODS)


def test_the_entry_trains_on_token_ids_in_bf16(tmp_path, monkeypatch):
    """`cli.train_multimodal --text_extractor gigachat3_1 --compute_dtype
    bfloat16` over a synthetic set's token ids, at the CPU sizes: one
    epoch through build_trainer and Trainer.train_epoch."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal

    torch.set_num_threads(4)
    monkeypatch.setattr(PG, "GIGACHAT3_1_EP32", GM.port_config(tiny_cfg()))
    trainer = train_multimodal.main([
        "--dataset_root", str(tmp_path / "ds"), "--synthetic",
        "--saving_dir", str(tmp_path / "runs"), "--modalities", "audio,text",
        "--text_extractor", "gigachat3_1", "--compute_dtype", "bfloat16",
        "--text_tokens", "16", "--audio_samples", "16000", "--batch_size",
        "4", "--epoch_num", "1", "--device", "cpu", "--log_console",
        "false"])
    ids = sorted(os.listdir(tmp_path / "ds" / "verbal" / "gigachat3_1_ids"))
    assert ids
    tower = trainer.state.model.extractors["text"]
    rows = tower.model.expert_rows()
    assert sorted(rows) == [1, 2] and all(int(r.sum()) > 0
                                          for r in rows.values())
    assert all(torch.isfinite(p).all()
               for p in trainer.state.model.parameters())
    assert os.path.isfile(os.path.join(trainer.run_dir, "checkpoint_current"))


def test_the_loader_gives_token_ids_and_lengths(tmp_path):
    from multimodalaggressionrecognition_tpu_torch.data.avabos import (
        MultimodalSource)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        TOKEN_IDS_TYPE, generate_synthetic_avabos)
    from multimodalaggressionrecognition_tpu_torch.data.transforms import (
        pad_ids)

    root = str(tmp_path / "ds")
    df, _ = generate_synthetic_avabos(root, token_vocab=256, text_len=20)
    verb = [i for i, a in enumerate(df["aggr_type"]) if a != "phys"][:3]
    src = MultimodalSource(df, root, MODS, transforms={"text": pad_ids(12)},
                           text_ids=TOKEN_IDS_TYPE)
    batch = src.build_batch(verb, pad_to=4)
    text = batch["modalities"]["text"]
    assert text["data"].dtype == "int64" and text["data"].shape == (4, 12)
    assert text["lengths"].dtype == "int64"
    assert ((1 <= text["data"]) & (text["data"] < 256)).any()
    for row, n in zip(text["data"], text["lengths"]):
        assert 4 <= n <= 12 and (row[n:] == 0).all() and (row[:n] > 0).all()


def test_the_reference_loads_neither_the_port_nor_jax():
    import subprocess
    import sys

    code = ("import sys, portbench.reference.gigachat\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in (\n"
            "    'jax', 'jaxlib', 'flax', 'multimodalaggressionrecognition_tpu',"
            "\n    'multimodalaggressionrecognition_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
