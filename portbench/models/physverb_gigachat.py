"""The audio,text PhysVerb model of the port's `cli/train_multimodal.py` with
GigaChat3.1's decoder as its text tower over transcript token ids
(`--text_extractor gigachat3_1`): the configuration's top-level keys (HF's
`deepseek_v3` names, one expert-parallel share) give the tower's sizes,
`fusion_hidden_size` the fusion's width, the rest is `physverb`'s
(`portbench/models/__init__.py` says what each name gives the harness).

It wires the plain reference (`reference/gigachat.py` over
`reference/model.py` and `reference/train.py`), draws token-id batches
(lognormal transcript lengths, Zipf ids over the first `drawn_ids` of
the vocabulary, right-padded) and builds the port's trainer as the training entry builds
it (`build_model` with the configuration's GigaChat geometry,
`cli/common.build_trainer`).  The routers' correction biases are buffers:
they do not train and are not checked.  The one hand-written kernel in a
step is K1, on the CNN1D audio tower's stem."""

import math

import torch

from ..reference import gigachat as G
from . import physverb

# CPU sizes: two 64-wide MoE layers after one dense, 16 experts in 4 groups
# over 4 shares (4 held here), transcripts of up to 32 ids over 256, 8 clips
# a batch (at 4 clips of 16 ids the bf16 loss's rounding reads above the
# cell's limit)
TINY = {"config": {"audio_samples": 16000, "text_tokens": 32,
                   "text_min_tokens": 4, "text_median_tokens": 16,
                   "vocab_size": 256, "drawn_ids": 256,
                   "hidden_size": 64,
                   "intermediate_size": 128, "moe_intermediate_size": 32,
                   "num_hidden_layers": 3, "first_k_dense_replace": 1,
                   "num_attention_heads": 4, "q_lora_rank": 32,
                   "kv_lora_rank": 16, "qk_nope_head_dim": 16,
                   "qk_rope_head_dim": 8, "v_head_dim": 24,
                   "n_routed_experts": 4, "expert_parallel": 4,
                   "n_group": 4, "topk_group": 2,
                   "num_experts_per_tok": 4},
        "job": {"batch_size": 8}}
GRAD_GROUPS = {"text_grad_gap": G.PRE + "."}  # the GigaChat tower's leaves

modalities = physverb.modalities
heads = physverb.heads
pool_config = physverb.pool_config
launch_plan = physverb.launch_plan
parameter_spec = G.parameter_spec


def text_lengths(g, cfg, batch: int, device):
    """Each transcript's token count: lognormal around the median, clipped
    to [text_min_tokens, text_tokens]."""
    z = torch.randn(batch, generator=g, device=device)
    n = torch.exp(math.log(cfg["text_median_tokens"])
                  + cfg["text_tokens_sigma"] * z).round()
    return n.clamp(cfg["text_min_tokens"], cfg["text_tokens"]).long()


def zipf_cdf(cfg, device):
    """The cumulative Zipf(s) distribution over the first `drawn_ids` ids,
    id 0 the most frequent."""
    ranks = torch.arange(1, cfg["drawn_ids"] + 1, dtype=torch.float64)
    p = ranks ** -cfg["token_zipf"]
    return (p.cumsum(0) / p.sum()).float().to(device)


def make_batch(g, cfg, modalities, batch: int, heads, device):
    """One batch as device tensors, drawn from generator `g`: N(0, 0.1)
    audio, token ids (B, text_tokens) int64 from the Zipf distribution,
    zero past each length, and the lengths."""
    mods = {}
    if "audio" in modalities:
        mods["audio"] = {"data": torch.randn(
            batch, cfg["audio_samples"], generator=g, device=device) * 0.1}
    if "text" in modalities:
        t = cfg["text_tokens"]
        lengths = text_lengths(g, cfg, batch, device)
        u = torch.rand(batch, t, generator=g, device=device)
        ids = torch.searchsorted(zipf_cdf(cfg, device), u).clamp(
            max=cfg["drawn_ids"] - 1)
        keep = torch.arange(t, device=device)[None] < lengths[:, None]
        mods["text"] = {"data": ids * keep, "lengths": lengths}
    for m in mods.values():
        m["present"] = torch.ones(batch, device=device)
    labels = {h: torch.randint(0, 2, (batch,), generator=g, device=device,
                               dtype=torch.int32) for h in heads}
    return {"modalities": mods, "labels": labels,
            "label_mask": {h: torch.ones(batch, device=device)
                           for h in heads},
            "sample_mask": torch.ones(batch, device=device)}


def draw_masks(g, cfg, job, modalities, device):
    return G.draw_masks(g, cfg, modalities, job["batch_size"], device)


def reference_trainer(weights, cfg, job, modalities, products=None):
    return G.GigaChatReferenceTrainer(weights, cfg, modalities,
                                      lr=job["learning_rate"],
                                      products=products)


def trainable_names(cfg, job, modalities):
    return [n for n, _, _ in G.parameter_spec(cfg, modalities)
            if G.is_trainable(n)]


def mean_length(cfg) -> float:
    """The mean transcript length `text_lengths` draws, by quadrature over
    the normal."""
    lo, hi = cfg["text_min_tokens"], cfg["text_tokens"]
    total, z, dz = 0.0, -8.0, 1e-3
    while z < 8.0:
        n = round(math.exp(math.log(cfg["text_median_tokens"])
                           + cfg["text_tokens_sigma"] * z))
        total += min(max(n, lo), hi) * math.exp(-z * z / 2) * dz
        z += dz
    return total / math.sqrt(2 * math.pi)


def meta_step(cfg, job):
    """The reference's step on meta tensors: the forward and backward of
    the whole model, every position of the padded batch through the
    attention and the dense parts, and each held expert on its expected
    share of the valid tokens' assignments (routing needs values)."""
    batch = job["batch_size"]
    mods, labelled = modalities(cfg, job), heads(cfg, job)
    meta = torch.device("meta")
    weights = {n: torch.empty(shape, device=meta)
               for n, shape, _ in G.parameter_spec(cfg, mods)}
    rows = G.expected_rows(cfg, batch * mean_length(cfg))
    ref = G.GigaChatReferenceTrainer(weights, cfg, mods, meta_rows=rows)
    t = cfg["text_tokens"]
    b = {"modalities": {
        "audio": {"data": torch.empty(batch, cfg["audio_samples"],
                                      device=meta),
                  "present": torch.empty(batch, device=meta)},
        "text": {"data": torch.empty(batch, t, dtype=torch.int64,
                                     device=meta),
                 "lengths": torch.empty(batch, dtype=torch.int64,
                                        device=meta),
                 "present": torch.empty(batch, device=meta)}},
        "labels": {h: torch.empty(batch, dtype=torch.int32, device=meta)
                   for h in labelled},
        "label_mask": {h: torch.empty(batch, device=meta)
                       for h in labelled}}
    masks = {k: (torch.empty(shape, device=meta), rate)
             for k, shape, rate in G.mask_shapes(cfg, mods, batch)}
    return lambda: ref.loss_and_grads(b, masks, whole=True)


def port_config(cfg):
    """The port's `GigaChatConfig` of the configuration's top-level keys."""
    from multimodalaggressionrecognition_tpu_torch.models.gigachat import \
        GigaChatConfig

    if (cfg["topk_method"], cfg["scoring_func"], cfg["hidden_act"]) != (
            "noaux_tc", "sigmoid", "silu") or cfg["attention_bias"] or \
            cfg["moe_layer_freq"] != 1 or cfg["num_nextn_predict_layers"]:
        raise ValueError("the port's GigaChat tower is deepseek_v3's noaux_tc "
                         "sigmoid router, SwiGLU experts in every layer after "
                         "the dense ones, no attention bias and no MTP")
    return GigaChatConfig.from_hf(cfg)


def build_trainer(cfg, job, modalities, weights, device, run_root):
    """The port's Trainer, as the training entry builds it with
    `--text_extractor gigachat3_1`, on `weights`."""
    from multimodalaggressionrecognition_tpu_torch.cli.common import \
        build_trainer as port_build_trainer
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.train.steps import LossSpec

    from ..harness import PoolLoader

    mcfg = MultimodalConfig(
        modalities=",".join(cfg["modalities"]), text_extractor="gigachat3_1",
        hidden_size=cfg["fusion_hidden_size"],
        fusion_layers=cfg["fusion_layers"], fusion_heads=cfg["fusion_heads"],
        adaptor_out=cfg["adaptor_out"], audio_samples=cfg["audio_samples"],
        text_tokens=cfg["text_tokens"], focal_gamma=cfg["focal_gamma"],
        batch_size=job["batch_size"], learning_rate=job["learning_rate"],
        compute_dtype=job["compute_dtype"], saving_dir=run_root,
        run_name="run", log_console=False, device=str(device))
    with torch.device(device):
        model = build_model(mcfg, tuple(cfg["modalities"]),
                            text_config=port_config(cfg))
    model.load_state_dict(weights, strict=True)
    loss_specs = {"phys": LossSpec("focal", class_weights=cfg["focal_alpha"],
                                   gamma=cfg["focal_gamma"]),
                  "verb": LossSpec("ce")}
    return port_build_trainer(mcfg, model, loss_specs, PoolLoader([]), [])


def family(kernel_name: str):
    """The tower's library kernels: the held experts' grouped products and
    the attention's flash kernels."""
    name = kernel_name.lower()
    if "flash" in name or "fmha" in name:
        return "flash attention (MLA)"
    if "grouped" in name or "groupproblemshape" in name:
        return "grouped GEMM (held experts)"
    return None
