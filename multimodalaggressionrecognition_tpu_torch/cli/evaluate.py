"""Evaluate a multimodal checkpoint on the test split (the JAX package's
cli/evaluate.py).

Loads a checkpoint (a training one, `checkpoint_current` /
`checkpoint_best_<head>`, or an inference one), runs the test clusters of
the intervals table through the PhysVerb model, and prints the reference's
metric set per head (loss, accuracy, per-class P/R/F1, UAR/UAP/UAF1).
Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.evaluate \
      --from_run runs/<run> --path_to_checkpoint runs/<run>/checkpoint_best_phys

The phys head's focal loss takes its default gamma (2.0), not
--focal_gamma, as the JAX CLI does: under --from_run of a run trained at
another gamma the printed phys loss differs from the training log's, the
metrics do not.  `--exported` (a serving artifact) is not ported.
"""

import json
from dataclasses import dataclass

from .common import compute_dtype, ensure_dataset, parse_config
from .train_multimodal import MultimodalConfig, build_model, make_loaders


@dataclass
class EvalConfig(MultimodalConfig):
    path_to_checkpoint: str = ""
    exported: str = ""  # a serving artifact: not ported


def _print_results(results):
    import numpy as np

    printable = {
        head: {k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
               for k, v in m.items()}
        for head, m in results.items()}
    print(json.dumps(printable, indent=2))


def main(argv=None):
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.loop import Trainer
    from ..train.state import OptimizerConfig
    from ..train.steps import LossSpec
    from .train_multimodal import class_weights_from_df

    cfg = parse_config(EvalConfig, argv)
    if cfg.exported:
        raise SystemExit("--exported is not ported: the PyTorch package has "
                         "no serving artifact yet (ROADMAP.md, queue 1 item "
                         "9); evaluate a checkpoint with --path_to_checkpoint")
    dtype = compute_dtype(cfg)
    device = resolve_device(cfg.device)  # fail before any data or model work
    modalities = tuple(cfg.modalities.split(","))
    df, split = ensure_dataset(cfg)
    train_loader, test_loader = make_loaders(cfg, df, split, modalities)
    model = seeded_init_(build_model(cfg, modalities), cfg.seed)
    loss_specs = {"phys": LossSpec("focal",
                                   class_weights=class_weights_from_df(
                                       df, "phys_aggr_label")),
                  "verb": LossSpec("ce")}
    trainer = Trainer(model, loss_specs, OptimizerConfig(learning_rate=1e-3),
                      train_loader, test_loader, num_classes=2,
                      saving_dir=cfg.saving_dir, model_name="evaluate",
                      device=device, log_console=False, compute_dtype=dtype)
    trainer.init_state()
    if cfg.path_to_checkpoint:
        # the weights of a training or an inference checkpoint (its EMA
        # shadow where it has one), strictly
        state_dict, _ = restore_variables(cfg.path_to_checkpoint)
        trainer.state.model.load_state_dict(state_dict, strict=True)
    results = trainer.eval_epoch()
    _print_results(results)
    return results


if __name__ == "__main__":
    main()
