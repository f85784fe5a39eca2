"""XLS-R 300M as the audio tower of the audio,text model (`cli/train_multimodal
--audio_extractor xlsr_300m`, models/wav2vec.py) against its plain
reference (portbench/reference/xlsr.py), at the benchmark model's CPU
sizes (portbench/models/physverb_xlsr.py `TINY`) on seeded random weights,
the dropout and time-mask draws taken by both sides from generators seeded
alike.

Tolerances: in float32 both sides compute the same function with the same
draws, and only the summation order of the library kernels differs (the
reference runs the tower in blocks of two clips and the positional conv
group by group), so the tokens, logits and loss are held to 1e-5 relative
and each first gradient to 1e-5 of its leaf's largest element.  After
three Adam steps each leaf's change is held to 1e-4 by its norm (Adam
divides by the root of the second moment, so an element whose gradient is
small moves by about the lr whatever rounding gave it, and elements are
not compared one by one; a key's bias under softmax has a gradient nought
but for rounding, so its rows are left out).  The time mask's spans are
integers: equal.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
    MultimodalConfig, build_model)
from multimodalaggressionrecognition_tpu_torch.models import wav2vec
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, train_step)
from portbench import inputs
from portbench.models import physverb_xlsr as XM
from portbench.reference import model as M
from portbench.reference import xlsr as X

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = ("audio", "text")
SEED = 3_000_000_019
LR = 3e-4
SPECS = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
         "verb": LossSpec("ce")}


def full_cfg():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "audiotext_xlsr300m.json")) as f:
        return json.load(f)


def tiny_cfg():
    return {**full_cfg(), **XM.TINY["config"], "focal_alpha": (0.5, 0.5)}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(4)
    cfg = tiny_cfg()
    weights = inputs.make_weights(X.parameter_spec(cfg, MODS), SEED, "cpu")
    g = torch.Generator().manual_seed(inputs.subseed(SEED, inputs.BATCHES))
    batches = [inputs.make_batch(g, cfg, MODS, 4, ("verb",), "cpu")
               for _ in range(3)]
    return cfg, weights, batches


def port_model(cfg, weights):
    mcfg = MultimodalConfig(audio_extractor="xlsr_300m",
                            audio_samples=cfg["audio_samples"],
                            text_tokens=cfg["text_tokens"], device="cpu")
    model = build_model(mcfg, MODS, audio_config=XM.port_config(cfg))
    model.load_state_dict(weights, strict=True)
    return model


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_forward_tokens_and_logits_match_the_reference(setup):
    cfg, weights, batches = setup
    model = port_model(cfg, weights).train()
    mods = batches[0]["modalities"]
    set_generator(model, torch.Generator().manual_seed(5))
    with torch.no_grad():
        tokens = model.extract_features(mods)["audio"]
    masks = X.draw_masks(torch.Generator().manual_seed(5), cfg, MODS, 4,
                         "cpu")
    prod = M.Products(None)
    conv = X.conv_features(mods["audio"]["data"], weights, cfg, prod)
    ref = X.tower(conv, weights, cfg, masks, slice(None), prod)
    assert tokens.shape == (4, X.frames(cfg), cfg["hidden_size"])
    assert rel(tokens, ref) < 1e-5

    set_generator(model, torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits = model(mods)
    masks = X.draw_masks(torch.Generator().manual_seed(6), cfg, MODS, 4,
                         "cpu")
    feats = {"audio": X.tower(conv, weights, cfg, masks, slice(None), prod),
             "text": mods["text"]["data"]}
    ref = M.heads_logits(feats, weights, cfg, masks, prod)
    for head in ("phys", "verb"):
        assert rel(logits[head], ref[head]) < 1e-5, head


def train(cfg, weights, batches, steps, compute_dtype=None):
    model = port_model(cfg, weights)
    state = create_train_state(model, OptimizerConfig(LR), "cpu")
    set_generator(state.model, torch.Generator().manual_seed(7))
    out = [train_step(state, batches[i], SPECS, 2, compute_dtype)
           for i in range(steps)]
    return state, out


def test_loss_and_first_gradients_match_the_reference(setup):
    cfg, weights, batches = setup
    state, (metrics,) = train(cfg, weights, batches, 1)
    ref = X.XlsrReferenceTrainer(weights, cfg, MODS, lr=LR, row_block=2)
    masks = X.draw_masks(torch.Generator().manual_seed(7), cfg, MODS, 4,
                         "cpu")
    loss, grads = ref.loss_and_grads(batches[0], masks)
    assert float(metrics["total_loss"]) == pytest.approx(float(loss),
                                                         rel=1e-5)
    params = dict(state.model.named_parameters())
    trained = [n for n, p in params.items() if p.requires_grad]
    assert sorted(trained) == sorted(XM.trainable_names(cfg, {}, MODS))
    assert set(grads) == set(trained)
    for n in trained:
        g = grads[n]
        assert (params[n].grad - g).abs().max() <= 1e-5 * g.abs().max(), n
    for leaf in ("masked_spec_embed", "pos_conv.weight_g",
                 "pos_conv.weight_v"):
        g = grads[f"{X.ENC}.{leaf}"]
        assert g.abs().max() > 0, leaf


def test_three_adam_steps_match_the_reference(setup):
    cfg, weights, batches = setup
    state, _ = train(cfg, weights, batches, 3)
    ref = X.XlsrReferenceTrainer(weights, cfg, MODS, lr=LR, row_block=2)
    g = torch.Generator().manual_seed(7)
    for b in batches:
        ref.step(b, X.draw_masks(g, cfg, MODS, 4, "cpu"))
    params = dict(state.model.named_parameters())
    changes = {n: (params[n].detach() - weights[n], ref.params[n] - weights[n])
               for n in ref.trainable}
    for n, (p, r) in changes.items():
        if n.endswith("in_proj_bias"):  # the keys' bias: nought gradient
            e = p.shape[0] // 3
            p, r = torch.cat([p[:e], p[2 * e:]]), torch.cat([r[:e], r[2 * e:]])
        assert torch.equal(p, r) or rel(p, r) <= 1e-4, n
    frozen = [n for n in params if n.startswith(X.FROZEN)]
    assert frozen and all(torch.equal(params[n], weights[n]) for n in frozen)


def test_the_frozen_encoder_has_no_gradient_and_no_optimizer_state(setup):
    cfg, weights, batches = setup
    state, _ = train(cfg, weights, batches, 1)
    encoder = state.model.extractors["audio"].encoder
    frozen = list(encoder.feature_extractor.parameters())
    assert frozen and all(not p.requires_grad and p.grad is None
                          for p in frozen)
    optimized = {id(p) for p in state.optimizer.params}
    assert not any(id(p) in optimized for p in frozen)
    assert not any(p in state.optimizer.inner.state for p in frozen)
    assert encoder.masked_spec_embed in state.optimizer.inner.state


def test_time_mask_spans_equal_the_references(setup):
    """At the cell's 499 frames, on draws with many equal keys: the port's
    spans on the card's path equal the reference's clip-by-clip ones, and
    each clip's count is floor(0.075 T / 10 + u), at least 2."""
    x = full_cfg()["xlsr"]
    g = torch.Generator().manual_seed(11)
    u = torch.rand(256, generator=g)
    keys = torch.floor(torch.rand(256, 490, generator=g) * 64) / 64
    got = wav2vec.mask_time_spans(u, keys, 0.075, 10, 2)
    assert torch.equal(got, X.time_mask(u, keys, x))
    counts = [X.span_count(v, 499, x) for v in u]
    assert counts == [max(2, math.floor(0.075 * 499 / 10 + float(v)))
                      for v in u]
    assert set(counts) == {3, 4}
    assert wav2vec.max_time_spans(0.075, 10, 2, 499) == 4


def test_the_port_masks_the_spans_of_the_reference_draws(setup):
    """The port's time mask draws its uniforms where `draw_masks` has them:
    the frames it replaces are the reference's."""
    cfg, weights, batches = setup
    model = port_model(cfg, weights).train()
    seen = []
    encoder = model.extractors["audio"].encoder
    encoder.time_mask.register_forward_hook(
        lambda m, args, out: seen.append((out != args[0]).any(dim=-1)))
    set_generator(model, torch.Generator().manual_seed(9))
    with torch.no_grad():
        model(batches[0]["modalities"])
    masks = X.draw_masks(torch.Generator().manual_seed(9), cfg, MODS, 4,
                         "cpu")
    want = X.time_mask(masks["xlsr.mask_count"][0],
                       masks["xlsr.mask_keys"][0], cfg["xlsr"])
    assert torch.equal(seen[0], want) and want.sum(dim=1).min() >= 10


def test_a_bf16_step_runs_end_to_end(setup):
    cfg, weights, batches = setup
    state, (metrics,) = train(cfg, weights, batches, 1, "bfloat16")
    assert math.isfinite(float(metrics["total_loss"]))
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32, n
        assert p.grad is None if n.startswith(X.FROZEN) else (
            p.grad.dtype == torch.float32 and bool(torch.isfinite(
                p.grad).all())), n


def test_the_flag_builds_the_published_tower():
    cfg = parse_config(MultimodalConfig, [
        "--modalities", "audio,text", "--audio_extractor", "xlsr_300m",
        "--audio_samples", "160000"])
    with torch.device("meta"):
        model = build_model(cfg, ("audio", "text"))
    assert model.feature_shapes["audio"] == (499, 768)
    encoder = model.extractors["audio"].encoder
    assert encoder.config == wav2vec.XLSR_300M == XM.port_config(full_cfg())
    assert len(encoder.layers) == 24
    layer = encoder.layers[0]
    assert layer.self_attn.in_proj_weight.shape == (3072, 1024)
    assert layer.self_attn.num_heads == 16
    assert layer.linear1.weight.shape == (4096, 1024)
    assert (layer.self_attn.dropout.rate, layer.dropout.rate,
            layer.activation_dropout.rate) == (0.1, 0.1, 0.0)
    assert encoder.pos_conv.weight_g.shape == (1, 1, 128)
    assert encoder.pos_conv.weight_v.shape == (1024, 64, 128)
    assert encoder.pos_conv.groups == 16
    assert encoder.masked_spec_embed.shape == (1024,)
    assert sum(p.numel() for p in encoder.parameters()) == 315_438_720
    assert not any(p.requires_grad
                   for p in encoder.feature_extractor.parameters())
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(
        n for n, _, _ in X.parameter_spec(full_cfg(), MODS))


def test_the_default_audio_tower_is_unchanged():
    cfg = parse_config(MultimodalConfig, ["--modalities", "audio,text"])
    assert cfg.audio_extractor == "cnn1d"
    with open(os.path.join(ROOT, "portbench", "configs",
                           "audiotext_flagship.json")) as f:
        flagship = json.load(f)
    with torch.device("meta"):
        model = build_model(cfg, ("audio", "text"))
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == {
        n: tuple(s) for n, s, _ in M.parameter_spec(flagship, MODS)}
    with pytest.raises(SystemExit):
        build_model(dataclasses.replace(cfg, audio_extractor="wav2vec2"),
                    ("audio", "text"))
