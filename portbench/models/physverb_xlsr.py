"""The audio,text PhysVerb model of the port's `cli/train_multimodal.py` with
XLS-R 300M as its audio tower (`--audio_extractor xlsr_300m`): the
configuration's `xlsr` group (HF's `Wav2Vec2Config` names) gives the
tower's sizes, the rest is `physverb`'s (`portbench/models/__init__.py`
says what each name gives the harness).

It wires the plain reference (`reference/xlsr.py` over `reference/model.py`
and `reference/train.py`), `physverb`'s batches and losses, and builds the
port's trainer as the training entry builds it (`build_model` with the
configuration's XLS-R geometry, `cli/common.build_trainer`).  The conv
feature encoder is frozen: its leaves do not train and are not checked.
The one hand-written kernel in a step is K1, on the encoder's conv0 (a
single-channel conv with a bias), in its forward alone."""

import torch

from .. import inputs
from ..reference import xlsr as X
from ..yardstick import peaks as P
from . import physverb

# CPU sizes: 1 s clips (49 frames), two 64-wide layers; the positional
# conv in 4 groups of 16 channels (the CPU's bf16 grouped convolution is
# wrong at 8 channels a group or fewer, torch 2.13; the published 64 are
# right)
TINY = {"config": {"audio_samples": 16000, "text_tokens": 8,
                   "text_min_tokens": 2,
                   "xlsr": {"conv_dim": [32] * 7,
                            "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                            "conv_stride": [5, 2, 2, 2, 2, 2, 2],
                            "conv_bias": True, "feat_extract_norm": "layer",
                            "do_stable_layer_norm": True, "hidden_size": 64,
                            "num_hidden_layers": 2,
                            "num_attention_heads": 4,
                            "intermediate_size": 128,
                            "num_conv_pos_embeddings": 128,
                            "num_conv_pos_embedding_groups": 4,
                            "attention_dropout": 0.1, "hidden_dropout": 0.1,
                            "feat_proj_dropout": 0.1,
                            "activation_dropout": 0.0, "layerdrop": 0.0,
                            "mask_time_prob": 0.075, "mask_time_length": 10,
                            "mask_time_min_masks": 2}},
        "job": {"batch_size": 4}}
GRAD_GROUPS = {"audio_grad_gap": X.PRE + "."}  # the XLS-R tower's leaves

modalities = physverb.modalities
heads = physverb.heads
pool_config = physverb.pool_config
make_batch = inputs.make_batch
parameter_spec = X.parameter_spec


def draw_masks(g, cfg, job, modalities, device):
    return X.draw_masks(g, cfg, modalities, job["batch_size"], device)


def reference_trainer(weights, cfg, job, modalities, products=None):
    return X.XlsrReferenceTrainer(weights, cfg, modalities,
                                  lr=job["learning_rate"], products=products)


def trainable_names(cfg, job, modalities):
    return [n for n, _, _ in X.parameter_spec(cfg, modalities)
            if not n.startswith(X.FROZEN)]


def launch_plan(cfg, job):
    """K1 on conv0 of the frozen encoder, one forward launch a step, in
    float32 under any compute dtype."""
    x = cfg["xlsr"]
    return {"framed_conv1d": [(1, P.k1_work(
        job["batch_size"], cfg["audio_samples"], x["conv_kernel"][0],
        x["conv_stride"][0], 0, x["conv_dim"][0]))]}


def meta_step(cfg, job):
    """The reference's step on meta tensors: the frozen encoder's forward,
    the forward and backward of the rest, nothing recomputed."""
    batch = job["batch_size"]
    mods, labelled = modalities(cfg, job), heads(cfg, job)
    meta = torch.device("meta")
    weights = {n: torch.empty(shape, device=meta)
               for n, shape, _ in X.parameter_spec(cfg, mods)}
    ref = X.XlsrReferenceTrainer(weights, cfg, mods)
    b = {"modalities": {m: {"data": torch.empty(s, device=meta),
                            "present": torch.empty(batch, device=meta)}
                        for m, s in inputs.batch_shapes(cfg, mods,
                                                        batch).items()},
         "labels": {h: torch.empty(batch, dtype=torch.int32, device=meta)
                    for h in labelled},
         "label_mask": {h: torch.empty(batch, device=meta)
                        for h in labelled}}
    masks = {k: (torch.empty(shape, device=meta), rate)
             for k, shape, rate in X.mask_shapes(cfg, mods, batch)}
    return lambda: ref.loss_and_grads(b, masks, whole=True)


def port_config(cfg):
    """The port's `FineTuneConfig` of the configuration's `xlsr` group."""
    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import \
        FineTuneConfig

    x = cfg["xlsr"]
    if x["layerdrop"] != 0 or not x["do_stable_layer_norm"] or \
            x["feat_extract_norm"] != "layer":
        raise ValueError("the port's XLS-R tower is pre-LN with a LayerNorm "
                         "after each conv and no LayerDrop")
    return FineTuneConfig(
        conv_layers=tuple(zip(x["conv_dim"], x["conv_kernel"],
                              x["conv_stride"])),
        extractor_mode="layer_norm", conv_bias=x["conv_bias"],
        embed_dim=x["hidden_size"], num_layers=x["num_hidden_layers"],
        num_heads=x["num_attention_heads"], ff_dim=x["intermediate_size"],
        dropout=x["hidden_dropout"], layer_norm_first=True,
        pos_conv_kernel=x["num_conv_pos_embeddings"],
        pos_conv_groups=x["num_conv_pos_embedding_groups"],
        attention_dropout=x["attention_dropout"],
        hidden_dropout=x["hidden_dropout"],
        feat_proj_dropout=x["feat_proj_dropout"],
        activation_dropout=x["activation_dropout"],
        pos_conv_weight_norm=True, mask_time_prob=x["mask_time_prob"],
        mask_time_length=x["mask_time_length"],
        mask_time_min_masks=x["mask_time_min_masks"],
        freeze_feature_encoder=True)


def build_trainer(cfg, job, modalities, weights, device, run_root):
    """The port's Trainer, as the training entry builds it with
    `--audio_extractor xlsr_300m`, on `weights`."""
    from multimodalaggressionrecognition_tpu_torch.cli.common import \
        build_trainer as port_build_trainer
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.train.steps import LossSpec

    from ..harness import PoolLoader

    mcfg = MultimodalConfig(
        modalities=",".join(cfg["modalities"]), audio_extractor="xlsr_300m",
        hidden_size=cfg["hidden_size"], fusion_layers=cfg["fusion_layers"],
        fusion_heads=cfg["fusion_heads"], adaptor_out=cfg["adaptor_out"],
        audio_samples=cfg["audio_samples"], text_tokens=cfg["text_tokens"],
        focal_gamma=cfg["focal_gamma"], batch_size=job["batch_size"],
        learning_rate=job["learning_rate"],
        compute_dtype=job["compute_dtype"], saving_dir=run_root,
        run_name="run", log_console=False, device=str(device))
    with torch.device(device):
        model = build_model(mcfg, tuple(cfg["modalities"]),
                            audio_config=port_config(cfg))
    model.load_state_dict(weights, strict=True)
    loss_specs = {"phys": LossSpec("focal", class_weights=cfg["focal_alpha"],
                                   gamma=cfg["focal_gamma"]),
                  "verb": LossSpec("ce")}
    return port_build_trainer(mcfg, model, loss_specs, PoolLoader([]), [])
