"""Shared CLI machinery: dataclass configs with generated argparse, and the
training half (dataset provisioning, optimizer, trainer).

Only the fields the ported paths read exist; the JAX package's other knobs
(`--from_run`, schedules, AdamW, clipping, accumulation, EMA, early
stopping, bf16, parallelism, profiling, TensorBoard, the compilation cache)
are listed in ROADMAP.md.  `make_optimizer` still reads the optimizer knobs
so that asking for one that is not ported fails instead of being ignored.
"""

import argparse
import dataclasses
import os
from dataclasses import dataclass


@dataclass
class TrainConfig:
    dataset_root: str = "data/avabos"
    saving_dir: str = "runs"
    model_name: str = ""
    # a fixed run dir <saving_dir>/<run_name>: a relaunch resumes from its
    # checkpoint_current
    run_name: str = ""
    batch_size: int = 16
    epoch_num: int = 50
    learning_rate: float = 1e-3  # torch.optim.Adam's default, as the reference
    seed: int = 0
    checkpoint_criterion: str = "UAR"
    resume_training: bool = False
    path_to_checkpoint: str = ""
    synthetic: bool = False
    num_threads: int = 4
    log_console: bool = True
    # not ported beyond their defaults: anything else raises
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0
    weight_decay: float = 0.0
    grad_accum_steps: int = 1
    compute_dtype: str = "float32"
    device: str = "cuda"


def clip_shapes_from_config(cfg, modalities):
    """Per-modality single-clip shapes under this config's padding."""
    all_shapes = {"audio": (cfg.audio_samples,),
                  "text": (cfg.text_tokens, cfg.hidden_size),
                  "video": (cfg.video_frames, cfg.video_size,
                            cfg.video_size, 3)}
    return {m: all_shapes[m] for m in modalities}


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected a boolean (true/false/1/0/yes/no/on/off), got {s!r}")


def parse_config(cls, argv=None, **overrides):
    # allow_abbrev=False: "--batch" must not silently mean --batch_size
    parser = argparse.ArgumentParser(description=cls.__doc__,
                                     allow_abbrev=False)
    for f in dataclasses.fields(cls):
        default = overrides.get(f.name, f.default)
        arg = f"--{f.name}"
        if f.type in (bool, "bool") or isinstance(default, bool):
            # bare flag toggles the default; an explicit true/false sets it
            parser.add_argument(arg, nargs="?", const=not default,
                                default=default, type=_parse_bool)
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(arg, type=typ, default=default)
    return cls(**vars(parser.parse_args(argv)))


def save_run_config(cfg, run_dir: str):
    """Persist the resolved config next to the logs and checkpoints."""
    import json

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"config_class": type(cfg).__name__,
                   **dataclasses.asdict(cfg)}, f, indent=1, default=str)


def ensure_dataset(cfg: TrainConfig, **synth_kwargs):
    """Generate the synthetic AVABOS tree when requested and missing;
    returns (intervals table, cluster split)."""
    import pandas as pd

    csv = os.path.join(cfg.dataset_root, "time_intervals.csv")
    if cfg.synthetic and not os.path.exists(csv):
        from ..data.synthetic import generate_synthetic_avabos

        generate_synthetic_avabos(cfg.dataset_root, **synth_kwargs)
    if not os.path.exists(csv):
        raise FileNotFoundError(
            f"{csv} not found; pass --synthetic to generate a fixture")
    from ..data.avabos import load_cluster_split

    df = pd.read_csv(csv)
    split = load_cluster_split(
        os.path.join(cfg.dataset_root, "train_test_split.json"))
    return df, split


def make_optimizer(cfg: TrainConfig) -> float:
    """The ported optimizer is the reference's: plain Adam at a constant
    learning rate (returned; train/state.py builds it).  Every other
    optimizer knob raises."""
    later = {"lr_schedule": (cfg.lr_schedule, "constant"),
             "warmup_steps": (cfg.warmup_steps, 0),
             "grad_clip_norm": (cfg.grad_clip_norm, 0.0),
             "weight_decay": (cfg.weight_decay, 0.0),
             "grad_accum_steps": (cfg.grad_accum_steps, 1)}
    for name, (value, plain) in later.items():
        if value != plain:
            raise SystemExit(
                f"--{name} {value} is not ported: the port trains with plain "
                "Adam at a constant learning rate; schedules, warmup, "
                "clipping, AdamW and accumulation arrive in a later slice")
    if cfg.compute_dtype != "float32":
        raise SystemExit(f"--compute_dtype {cfg.compute_dtype} is not ported: "
                         "the port trains in float32; bf16 arrives in a "
                         "later slice")
    return cfg.learning_rate


def build_trainer(cfg: TrainConfig, model, loss_specs, train_loader,
                  test_loader, num_classes: int = 2):
    from ..serve import resolve_device
    from ..train.loop import Trainer

    learning_rate = make_optimizer(cfg)
    run_dir = (os.path.join(cfg.saving_dir, cfg.run_name) if cfg.run_name
               else None)
    trainer = Trainer(
        model, loss_specs, learning_rate, train_loader, test_loader,
        num_classes=num_classes, saving_dir=cfg.saving_dir,
        model_name=cfg.model_name, device=resolve_device(cfg.device),
        checkpoint_criterion=cfg.checkpoint_criterion, seed=cfg.seed,
        log_console=cfg.log_console, run_dir=run_dir)
    save_run_config(cfg, trainer.run_dir)
    return trainer


def run_training(cfg: TrainConfig, trainer):
    if cfg.resume_training and cfg.path_to_checkpoint:
        trainer.load_checkpoint(cfg.path_to_checkpoint)
    elif cfg.run_name:
        trainer.resume_latest()
    trainer.fit(cfg.epoch_num)
    trainer.plot_logs()
    return trainer
