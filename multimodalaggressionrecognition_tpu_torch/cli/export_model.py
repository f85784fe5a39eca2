"""Export a trained checkpoint to a self-contained serving artifact (the
JAX package's cli/export_model.py).

Runs `torch.export` on the Predictor's forward with the weights baked in
(io/export.py), so a serving process needs no model class, checkpoint
restore or weight conversion: `io.export.ExportedPredictor` and the
artifact directory (`cli.serve --exported <dir>`, `cli.predict
--exported`, `cli.evaluate --exported`).  The kernels K1, K2 and K4 stay in
the artifact as `mar_torch::` custom ops.

  python -m multimodalaggressionrecognition_tpu_torch.cli.export_model \\
      --from_run runs/<run> \\
      --path_to_checkpoint runs/<run>/checkpoint_best_verb \\
      --output_dir exported/verb_model

`--entry` picks which train CLI's model to build (default
train_multimodal), and the other flags are that entry's own config; each
entry declares its per-modality clip shapes (`export_spec(cfg)`), which the
artifact's meta carries.  `--quantize int8|w8a8` exports the quantized
forward, and `--compute_dtype bfloat16` the bf16 one, for every entry.
The export traces on `--device` (CUDA unless `--device cpu`);
`--platforms` (default cpu,cuda) lists the devices the artifact may be
scored on.  `--native true` (JAX: keep Mosaic custom calls, TPU only) is
refused: the port's artifact always keeps its kernels.
"""

import dataclasses
import importlib
import json
import os
import sys

import numpy as np

_ENTRIES = ("train_multimodal", "train_text_transformer", "train_audio_rnn",
            "train_audio_transformer", "train_video_transformer",
            "train_video_rnn", "train_audio_text", "train3dcnn")

_EXPORT_FIELDS = [
    ("output_dir", str, "exported_model"),
    ("platforms", str, "cpu,cuda"),  # devices the artifact may score on
    ("native", bool, False),         # JAX's TPU-only Mosaic artifact
    ("quantize", str, ""),           # '', 'int8' (weight-only), 'w8a8'
    # explicit opt-in for exporting untrained weights (smoke tests only)
    ("allow_random_weights", bool, False),
]


def _entry_config_cls(mod):
    """The entry CLI's one TrainConfig dataclass, defined in its module."""
    from .common import TrainConfig

    found = [v for v in vars(mod).values()
             if isinstance(v, type) and dataclasses.is_dataclass(v)
             and issubclass(v, TrainConfig) and v is not TrainConfig
             and v.__module__ == mod.__name__]
    assert len(found) == 1, (mod.__name__, found)
    return found[0]


def _build_model_and_spec(mod, cfg):
    if hasattr(mod, "build_model"):  # train_multimodal: modality-driven
        from .common import clip_shapes_from_config

        modalities = tuple(sorted(cfg.modalities.split(",")))
        return (mod.build_model(cfg, modalities),
                clip_shapes_from_config(cfg, modalities))
    return mod.make_model(cfg), mod.export_spec(cfg)


def main(argv=None):
    from ..io.checkpoint import restore_variables
    from ..io.export import ARTIFACT, export_predictor
    from ..models.layers import seeded_init_
    from ..serve import Predictor, resolve_device
    from .common import compute_dtype, flag_value, parse_config, quantize_mode

    entry_name = flag_value(sys.argv[1:] if argv is None else argv, "entry",
                            "train_multimodal")
    if entry_name not in _ENTRIES:
        raise SystemExit(f"--entry must be one of {_ENTRIES} "
                         f"(got {entry_name!r})")
    mod = importlib.import_module(f".{entry_name}", package=__package__)
    cfg_cls = dataclasses.make_dataclass(
        "ExportConfig",
        [("entry", str, dataclasses.field(default=entry_name))]
        + [(n, t, dataclasses.field(default=d)) for n, t, d in _EXPORT_FIELDS],
        bases=(_entry_config_cls(mod),))
    cfg = parse_config(cfg_cls, argv)
    if cfg.native:
        raise SystemExit(
            "--native true keeps the TPU's Mosaic kernels and is TPU-only; "
            "the PyTorch artifact always keeps its CUDA kernels as "
            "mar_torch:: ops (io/export.py)")
    device = resolve_device(cfg.device)  # fail before any model work
    quantize = quantize_mode(cfg)

    model, spec = _build_model_and_spec(mod, cfg)
    example = {m: np.zeros((1,) + tuple(shape), np.float32)
               for m, shape in spec.items()}
    state_dict = None
    if cfg.path_to_checkpoint:
        state_dict, _ = restore_variables(cfg.path_to_checkpoint)
    elif cfg.allow_random_weights:
        seeded_init_(model, cfg.seed)
    else:
        raise SystemExit(
            "--path_to_checkpoint is required: exporting freshly "
            "initialized weights produces a garbage-scoring artifact "
            "(pass --allow_random_weights true for smoke tests)")

    predictor = Predictor(model, state_dict, batch_size=cfg.batch_size,
                          device=device, compute_dtype=compute_dtype(cfg),
                          quantize=quantize)
    meta = export_predictor(
        predictor, example, cfg.output_dir,
        platforms=tuple(p for p in cfg.platforms.split(",") if p))
    print(json.dumps({"exported": cfg.output_dir, "entry": entry_name,
                      "artifact_bytes": os.path.getsize(
                          os.path.join(cfg.output_dir, ARTIFACT)),
                      **meta}), flush=True)
    return meta


if __name__ == "__main__":
    main()
