"""Evaluate a multimodal checkpoint on the test split (the JAX package's
cli/evaluate.py).

Loads a checkpoint (a training one, `checkpoint_current` /
`checkpoint_best_<head>`, or an inference one), runs the test clusters of
the intervals table through the PhysVerb model, and prints the reference's
metric set per head (loss, accuracy, per-class P/R/F1, UAR/UAP/UAF1).
Runs on CUDA unless --device cpu.  `--data_parallel` and
`--model_parallelism` split the test batches (and the transformer blocks)
over a torchrun launch exactly as in training; rank 0 prints.

  python -m multimodalaggressionrecognition_tpu_torch.cli.evaluate \
      --from_run runs/<run> --path_to_checkpoint runs/<run>/checkpoint_best_phys

The phys head's focal loss takes its default gamma (2.0), not
--focal_gamma, as the JAX CLI does: under --from_run of a run trained at
another gamma the printed phys loss differs from the training log's, the
metrics do not.

`--exported <dir>` evaluates an artifact of cli/export_model.py instead
(no model class or checkpoint load): a batch missing one of the artifact's
modalities is scored with zero stubs and present=0 rows, which the model
treats as the training-time EMPTY protocol.  It prints the same metrics
without the loss (the artifact gives logits only).
"""

import json
from dataclasses import dataclass

from .common import compute_dtype, ensure_dataset, parse_config
from .train_multimodal import MultimodalConfig, build_model, make_loaders


@dataclass
class EvalConfig(MultimodalConfig):
    path_to_checkpoint: str = ""
    exported: str = ""  # an artifact dir of cli/export_model.py


def _print_results(results):
    import numpy as np

    printable = {
        head: {k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
               for k, v in m.items()}
        for head, m in results.items()}
    print(json.dumps(printable, indent=2))


def _eval_exported(cfg):
    """Score the test split through an exported artifact: the Trainer eval
    path's per-head confusion-matrix metrics, without a loss column."""
    import numpy as np
    import torch

    from ..io.export import ExportedPredictor
    from ..ops.metrics import confusion_matrix, metrics_from_confusion
    from ..serve import resolve_device

    if cfg.path_to_checkpoint:
        raise SystemExit(
            "--exported conflicts with --path_to_checkpoint: the artifact's "
            "weights were baked in at export time")
    exported = ExportedPredictor(cfg.exported,
                                 device=resolve_device(cfg.device))
    # the artifact fixes the batch and clip shapes: the loader pads to them
    cfg.batch_size = exported.batch_size
    cfg.modalities = ",".join(exported.modalities)
    shapes = exported.clip_shapes
    if "audio" in shapes:
        cfg.audio_samples = shapes["audio"][0]
    if "text" in shapes:
        cfg.text_tokens = shapes["text"][0]
    if "video" in shapes:
        # the loader pads the frame axis only; the frames' size comes from
        # the stored clips and is checked against the artifact per batch
        cfg.video_frames = shapes["video"][0]
    df, split = ensure_dataset(cfg)
    _, test_loader = make_loaders(cfg, df, split, tuple(exported.modalities))
    device = exported.device
    zeros = {m: {"data": torch.zeros((exported.batch_size, *shapes[m]),
                                     device=device),
                 "present": torch.zeros((exported.batch_size,),
                                        device=device)}
             for m in exported.modalities}
    acc = {}
    for batch in test_loader:
        request = {}
        for m in exported.modalities:
            if m not in batch["modalities"]:
                request[m] = zeros[m]
                continue
            leaf = {k: torch.as_tensor(v).to(device)
                    for k, v in batch["modalities"][m].items()
                    if k in ("data", "present")}
            got = tuple(leaf["data"].shape[1:])
            if got != shapes[m]:
                raise SystemExit(
                    f"dataset {m} clips are shaped {got} but the artifact "
                    f"was exported for {shapes[m]}; re-export at the "
                    "dataset's shapes (or re-prepare the dataset)")
            request[m] = leaf
        outputs = exported._forward(request)
        for head, logits in outputs.items():
            if head not in batch["labels"]:
                continue
            cm = confusion_matrix(
                logits.float().argmax(dim=-1),
                torch.as_tensor(batch["labels"][head]).to(device),
                exported.head_classes[head],
                row_mask=torch.as_tensor(batch["label_mask"][head]).to(
                    device))
            acc[head] = acc.get(head, 0.0) + cm  # summed on the device
    results = {head: metrics_from_confusion(np.asarray(cm.cpu()))
               for head, cm in acc.items()}
    _print_results(results)
    return results


def main(argv=None):
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.loop import Trainer
    from ..train.state import OptimizerConfig
    from ..train.steps import LossSpec
    from .common import make_parallelism
    from .train_multimodal import class_weights_from_df

    cfg = parse_config(EvalConfig, argv)
    if cfg.exported:
        return _eval_exported(cfg)
    dtype = compute_dtype(cfg)
    device = resolve_device(cfg.device)  # fail before any data or model work
    mesh = make_parallelism(cfg)
    modalities = tuple(cfg.modalities.split(","))
    df, split = ensure_dataset(cfg)
    train_loader, test_loader = make_loaders(cfg, df, split, modalities)
    model = seeded_init_(build_model(cfg, modalities), cfg.seed)
    loss_specs = {"phys": LossSpec("focal",
                                   class_weights=class_weights_from_df(
                                       df, "phys_aggr_label")),
                  "verb": LossSpec("ce")}
    if cfg.path_to_checkpoint:
        # the weights of a training or an inference checkpoint (its EMA
        # shadow where it has one), strictly, before the mesh splits them
        state_dict, _ = restore_variables(cfg.path_to_checkpoint)
        model.load_state_dict(state_dict, strict=True)
    trainer = Trainer(model, loss_specs, OptimizerConfig(learning_rate=1e-3),
                      train_loader, test_loader, num_classes=2,
                      saving_dir=cfg.saving_dir, model_name="evaluate",
                      device=device, log_console=False, compute_dtype=dtype,
                      mesh=mesh)
    trainer.init_state()
    results = trainer.eval_epoch()
    trainer.on_main(_print_results, results)
    return results


if __name__ == "__main__":
    main()
