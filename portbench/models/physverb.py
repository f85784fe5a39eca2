"""The PhysVerb model of the port's `cli/train_multimodal.py`: CNN1D audio,
text tokens as they are, a Swin3D-T video tower, a post-LN fusion encoder
and the `phys` and `verb` heads (`portbench/models/__init__.py` says what
each name gives the harness).

It wires the plain reference (`reference/model.py`, `reference/train.py`),
the batch functions of `inputs.py` and the launch plan of
`yardstick/launches.py`, and builds the port's trainer as the training
entry builds it (`cli/train_multimodal.build_model`,
`cli/common.build_trainer`)."""

import torch

from .. import inputs
from ..reference import model as M
from ..reference.train import ReferenceTrainer
from ..yardstick import launches as L

TINY = {"config": {"audio_samples": 16000, "text_tokens": 8,
                   "text_min_tokens": 2, "video_frames": 16, "video_size": 32},
        "job": {"batch_size": 4}}
VIDEO = "extractors.video."  # the Swin tower's leaves
GRAD_GROUPS = {"video_grad_gap": VIDEO}

modalities = L.job_modalities
parameter_spec = M.parameter_spec
make_batch = inputs.make_batch
launch_plan = L.plan


def heads(cfg, job):
    return L.HEADS[job["aggr_type"]]


def video_trains(job, modalities):
    return "video" in modalities and not job["video_freeze"]


def pool_config(pool, heads):
    """The focal loss's class weights on `phys`, from the pool's labels."""
    return {"focal_alpha": inputs.class_weights(pool) if "phys" in heads
            else (0.5, 0.5)}


def draw_masks(g, cfg, job, modalities, device):
    return M.draw_masks(g, cfg, modalities, job["batch_size"],
                        video_trains(job, modalities), device)


def reference_trainer(weights, cfg, job, modalities, products=None):
    return ReferenceTrainer(weights, cfg, modalities,
                            video_trains(job, modalities),
                            lr=job["learning_rate"], products=products)


def trainable_names(cfg, job, modalities):
    trains = video_trains(job, modalities)
    return [n for n, _, _ in M.parameter_spec(cfg, modalities)
            if not M.is_buffer(n) and (trains or not n.startswith(VIDEO))]


def meta_step(cfg, job):
    """The reference's step on meta tensors: the forward and backward of
    the parts that train, the forward alone of a frozen tower, and nothing
    recomputed."""
    batch = job["batch_size"]
    mods, labelled = modalities(cfg, job), heads(cfg, job)
    meta = torch.device("meta")
    weights = {n: torch.empty(shape, device=meta)
               for n, shape, _ in M.parameter_spec(cfg, mods)}
    trains = video_trains(job, mods)
    ref = ReferenceTrainer(weights, cfg, mods, trains)
    b = {"modalities": {m: {"data": torch.empty(s, device=meta),
                            "present": torch.empty(batch, device=meta)}
                        for m, s in inputs.batch_shapes(cfg, mods,
                                                        batch).items()},
         "labels": {h: torch.empty(batch, dtype=torch.int32, device=meta)
                    for h in labelled},
         "label_mask": {h: torch.empty(batch, device=meta)
                        for h in labelled}}
    masks = {k: (torch.empty(shape, device=meta), rate)
             for k, shape, rate in M.mask_shapes(cfg, mods, batch, trains)}
    return lambda: ref.loss_and_grads(b, masks, whole=True)


def build_trainer(cfg, job, modalities, weights, device, run_root):
    """The port's Trainer, as the training entry builds it, on `weights`."""
    from multimodalaggressionrecognition_tpu_torch.cli.common import \
        build_trainer as port_build_trainer
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.train.steps import LossSpec

    from ..harness import PoolLoader

    mcfg = MultimodalConfig(
        modalities=",".join(cfg["modalities"]),
        hidden_size=cfg["hidden_size"], fusion_layers=cfg["fusion_layers"],
        fusion_heads=cfg["fusion_heads"], adaptor_out=cfg["adaptor_out"],
        audio_samples=cfg["audio_samples"], text_tokens=cfg["text_tokens"],
        video_frames=cfg.get("video_frames", 128),
        video_size=cfg.get("video_size", 112),
        video_window=cfg.get("video_window", 8),
        swin_gelu=cfg.get("swin_gelu", "poly"),
        video_freeze=job["video_freeze"], video_remat=job["video_remat"],
        video_remat_policy=job["video_remat_policy"],
        focal_gamma=cfg["focal_gamma"], batch_size=job["batch_size"],
        learning_rate=job["learning_rate"],
        compute_dtype=job["compute_dtype"], saving_dir=run_root,
        run_name="run", log_console=False, device=str(device))
    with torch.device(device):
        model = build_model(mcfg, tuple(cfg["modalities"]))
    model.load_state_dict(weights, strict=True)
    loss_specs = {"phys": LossSpec("focal", class_weights=cfg["focal_alpha"],
                                   gamma=cfg["focal_gamma"]),
                  "verb": LossSpec("ce")}
    return port_build_trainer(mcfg, model, loss_specs, PoolLoader([]), [])
