"""Shared CLI machinery: dataclass configs with generated argparse, and the
training half (dataset provisioning, optimizer, trainer).

`TrainConfig` carries the JAX package's training knobs: the optimizer chain
(`--lr_schedule`, `--lr_decay_steps`, `--lr_decay_rate`, `--warmup_steps`,
`--grad_clip_norm`, `--weight_decay`, `--grad_accum_steps`), the EMA
(`--ema_decay`), early stopping, the profiler, TensorBoard and
`--compute_dtype` (bfloat16 on every train entry, as in the JAX package;
`generate_features` calls `require_float32`) and the parallelism
(`--data_parallel`, `--model_parallelism`: `make_parallelism`).  Not
ported, by design: the XLA compilation cache.

A data- or tensor-parallel run is one `torchrun` launch, one process per
device (NCCL on CUDA, gloo with `--device cpu`):

  torchrun --nproc_per_node 4 -m \
      multimodalaggressionrecognition_tpu_torch.cli.train_multimodal \
      --data_parallel [--model_parallelism 2] ...

Without torchrun's environment `--data_parallel` is a world of one rank.
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
    lr_schedule: str = "constant"  # constant | cosine | exponential
    lr_decay_steps: int = 10000
    lr_decay_rate: float = 0.95
    warmup_steps: int = 0  # a linear warmup joined in front of the schedule
    grad_clip_norm: float = 0.0  # 0: off; else clip by the global norm
    weight_decay: float = 0.0  # 0: Adam; else AdamW
    grad_accum_steps: int = 1  # micro-batches per optimizer update
    ema_decay: float = 0.0  # 0: off; else eval and serve the EMA shadow
    early_stop_patience: int = 0  # 0: off; else stop after N flat epochs
    # "float32", or "bfloat16" (f32 master parameters, optimizer state,
    # BatchNorm statistics and losses; bf16 parameters and inputs inside
    # the step, each layer computing in its input's dtype)
    compute_dtype: str = "float32"
    # torch.profiler Chrome trace of one training epoch ('' = off), epoch
    # min(profile_epoch, epoch_num - 1)
    profile_dir: str = ""
    profile_epoch: int = 1
    # TensorBoard scalars <head>/<split>/<metric> per epoch ('' = off)
    tensorboard_dir: str = ""
    # Tensor parallelism degree N (> 1: a (ranks / N data) x (N model)
    # mesh: batches split on `data`, the transformer blocks' attention
    # heads and feed-forward columns Megatron-split on `model`,
    # parallel/sharding_rules.py).  1 = off.
    model_parallelism: int = 1
    # Pure data parallelism over every rank of the launch (batch split on
    # the `data` axis, parameters and optimizer replicated; the gradients
    # summed over the data group).  Implied by model_parallelism > 1.
    data_parallel: bool = False
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
# the device (a run trained with --device cpu must not move a later
# evaluate or predict to the CPU without the caller asking) and the
# launch's layout (a torchrun run's --data_parallel / --model_parallelism
# would not fit a one-process evaluate)
_FROM_RUN_EXCLUDE = frozenset({
    "path_to_checkpoint", "resume_training", "run_name", "saving_dir",
    "profile_dir", "epoch_num", "batch_size", "num_threads", "log_console",
    "device", "data_parallel", "model_parallelism"})


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


def make_optimizer(cfg: TrainConfig):
    """The optimizer chain of the config (train/state.py): [accumulation]
    over [clip] -> Adam or AdamW at the schedule, the JAX package's
    make_optimizer.  The defaults are the reference's plain Adam at a
    constant rate."""
    from ..train.state import OptimizerConfig

    try:
        return OptimizerConfig(
            learning_rate=cfg.learning_rate, lr_schedule=cfg.lr_schedule,
            lr_decay_steps=cfg.lr_decay_steps,
            lr_decay_rate=cfg.lr_decay_rate, warmup_steps=cfg.warmup_steps,
            grad_clip_norm=cfg.grad_clip_norm, weight_decay=cfg.weight_decay,
            grad_accum_steps=cfg.grad_accum_steps)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def compute_dtype(cfg):
    """--compute_dtype as a torch dtype, or None for float32; an unknown
    name exits."""
    import torch

    from ..utils.precision import resolve_dtype

    try:
        dtype = resolve_dtype(cfg.compute_dtype)
    except ValueError as e:
        raise SystemExit(f"--compute_dtype: {e}") from None
    return None if dtype == torch.float32 else dtype


def quantize_mode(cfg):
    """--quantize as the mode serve.Predictor takes: None for '', else
    'int8' or 'w8a8'; any other name exits."""
    from ..utils.quantize import MODES

    if cfg.quantize and cfg.quantize not in MODES:
        raise SystemExit(f"--quantize: unknown quantize mode "
                         f"{cfg.quantize!r}; one of {MODES}")
    return cfg.quantize or None


def require_float32(cfg, entry: str):
    """--compute_dtype other than float32 exits, for an entry that always
    runs in f32: the JAX package's `generate_features` parses the flag and
    ignores it, so its tokens are f32 whatever the flag says, and this
    entry refuses the flag rather than ignore it."""
    if compute_dtype(cfg) is not None:
        raise SystemExit(f"--compute_dtype {cfg.compute_dtype}: {entry} "
                         "always runs in float32 (the JAX package's "
                         f"{entry} ignores the flag), so it takes float32 "
                         "only")


def check_parallelism(n: int, tp: int, batch_size: int) -> int:
    """The data axis of `n` ranks at tensor parallelism `tp`, or exit with
    the JAX package's words (its arguments count devices; here each rank
    is one)."""
    if tp > 1 and n % tp != 0:
        raise SystemExit(
            f"--model_parallelism {tp} does not divide the {n} available "
            "devices")
    dp = n // max(tp, 1)
    if batch_size % dp != 0:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the data "
            f"axis ({n} devices / tp {max(tp, 1)} = {dp})")
    return dp


def make_parallelism(cfg):
    """This rank's parallel.mesh.Mesh for --data_parallel /
    --model_parallelism, or None when neither is set (one process, as
    before).  The launch is torchrun's (RANK, WORLD_SIZE, LOCAL_RANK), a
    process group already up (tests), or a world of one rank; its size is
    checked before any group comes up."""
    tp = int(getattr(cfg, "model_parallelism", 1))
    if tp <= 1 and not getattr(cfg, "data_parallel", False):
        return None
    from ..parallel.mesh import (init_from_env, launch_world_size,
                                 local_device, make_mesh)
    from ..serve import resolve_device

    check_parallelism(launch_world_size(), tp, cfg.batch_size)
    device = local_device(resolve_device(cfg.device))
    init_from_env(device)
    return make_mesh(model_parallelism=max(tp, 1), device=device)


def build_trainer(cfg: TrainConfig, model, loss_specs, train_loader,
                  test_loader, num_classes: int = 2, on_epoch_start=None):
    """The entry's Trainer with every knob of `cfg`, --compute_dtype and
    the parallelism included."""
    from ..serve import resolve_device
    from ..train.loop import Trainer

    mesh = make_parallelism(cfg)
    run_dir = (os.path.join(cfg.saving_dir, cfg.run_name) if cfg.run_name
               else None)
    trainer = Trainer(
        model, loss_specs, make_optimizer(cfg), train_loader, test_loader,
        num_classes=num_classes, saving_dir=cfg.saving_dir,
        model_name=cfg.model_name, device=resolve_device(cfg.device),
        checkpoint_criterion=cfg.checkpoint_criterion, seed=cfg.seed,
        log_console=cfg.log_console, run_dir=run_dir,
        on_epoch_start=on_epoch_start, compute_dtype=compute_dtype(cfg),
        ema_decay=cfg.ema_decay,
        early_stop_patience=cfg.early_stop_patience,
        profile_dir=cfg.profile_dir or None, profile_epoch=cfg.profile_epoch,
        tensorboard_dir=cfg.tensorboard_dir or None, mesh=mesh)
    trainer.on_main(save_run_config, cfg, trainer.run_dir)
    return trainer


def run_training(cfg: TrainConfig, trainer):
    if cfg.resume_training and cfg.path_to_checkpoint:
        trainer.load_checkpoint(cfg.path_to_checkpoint)
    elif cfg.run_name:
        trainer.resume_latest()
    trainer.fit(cfg.epoch_num)
    trainer.plot_logs()
    return trainer
