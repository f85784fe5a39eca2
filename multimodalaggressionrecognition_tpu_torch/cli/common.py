"""Shared CLI machinery: dataclass configs with generated argparse, and the
training half (dataset provisioning, optimizer, trainer).

Only the fields the ported paths read exist; the JAX package's other knobs
(schedules, AdamW, clipping, accumulation, EMA, early stopping, bf16,
parallelism, profiling, TensorBoard, the compilation cache) are listed in
ROADMAP.md.  `make_optimizer` still reads the optimizer knobs so that
asking for one that is not ported fails instead of being ignored.
`--from_run <run dir>` fills every field not passed on the command line
from the run's saved config.json.
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


@dataclass
class NamesPinConfig(TrainConfig):
    """TrainConfig + the reference's train_names.txt order pin for the flat
    filename-labelled dataset entries: `--train_names` / `--test_names`
    name newline-separated file lists that fix a split's members and their
    order (default: the directory's sorted listing)."""
    train_names: str = ""
    test_names: str = ""


def pinned_files(cfg, split: str):
    """`files=` for FilenameLabelSource from --{split}_names (None: the
    sorted directory listing)."""
    path = getattr(cfg, f"{split}_names", "")
    if not path:
        return None
    from ..data.files import read_names_file

    return read_names_file(path)


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


def flag_value(args, name, default):
    """Last occurrence of `--name VALUE` or `--name=VALUE` in an arg list
    (sweep's peek at the passthrough's --saving_dir)."""
    out = default
    for i, a in enumerate(args):
        if a == f"--{name}" and i + 1 < len(args):
            out = args[i + 1]
        elif a.startswith(f"--{name}="):
            out = a.split("=", 1)[1]
    return out


# fields never inherited through --from_run: the run's identity and resume
# knobs, sizes whose training-time values are wrong for a new invocation,
# and the device (a run trained with --device cpu must not move a later
# evaluate or predict to the CPU without the caller asking)
_FROM_RUN_EXCLUDE = frozenset({
    "path_to_checkpoint", "resume_training", "run_name", "saving_dir",
    "epoch_num", "batch_size", "num_threads", "log_console", "device"})


def parse_config(cls, argv=None, **overrides):
    import sys

    # allow_abbrev=False: --from_run tells the explicitly passed flags by
    # their argv tokens, which needs argparse never to expand a prefix
    # ("--batch" must not mean --batch_size)
    parser = argparse.ArgumentParser(description=cls.__doc__,
                                     allow_abbrev=False)
    parser.add_argument(
        "--from_run", default="",
        help="run directory (or a checkpoint inside one): take every field "
             "not passed explicitly from the run's saved config.json")
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
    kwargs = vars(parser.parse_args(argv))
    from_run = kwargs.pop("from_run")
    if from_run:
        explicit = {a.split("=", 1)[0].lstrip("-")
                    for a in (sys.argv[1:] if argv is None else argv)
                    if a.startswith("--")}
        saved = load_run_config(from_run)
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in saved.items():
            if (k in names and k not in explicit
                    and k not in _FROM_RUN_EXCLUDE):
                kwargs[k] = v
    return cls(**kwargs)


def save_run_config(cfg, run_dir: str):
    """Persist the resolved config next to the logs and checkpoints."""
    import json

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"config_class": type(cfg).__name__,
                   **dataclasses.asdict(cfg)}, f, indent=1, default=str)


def load_run_config(path: str) -> dict:
    """The config.json of the run dir `path`, or of the run dir holding the
    checkpoint `path`."""
    import json

    for candidate in (path, os.path.dirname(path.rstrip("/"))):
        cfg_path = os.path.join(candidate, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                saved = json.load(f)
            saved.pop("config_class", None)
            return saved
    raise FileNotFoundError(
        f"no config.json under {path!r} (or its parent); --from_run needs "
        "a run directory produced by a train CLI")


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
    require_float32(cfg, "trains")
    return cfg.learning_rate


def require_float32(cfg, runs: str):
    """--compute_dtype other than float32 raises: the port `runs` (trains,
    extracts) in f32 only."""
    if cfg.compute_dtype != "float32":
        raise SystemExit(f"--compute_dtype {cfg.compute_dtype} is not ported: "
                         f"the port {runs} in float32; bf16 arrives in a "
                         "later slice")


def build_trainer(cfg: TrainConfig, model, loss_specs, train_loader,
                  test_loader, num_classes: int = 2, on_epoch_start=None):
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
        log_console=cfg.log_console, run_dir=run_dir,
        on_epoch_start=on_epoch_start)
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
