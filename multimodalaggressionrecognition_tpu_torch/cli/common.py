"""Shared CLI config machinery: dataclass configs with generated argparse.

Only the fields serving reads are ported so far; the trainer's fields
arrive with the trainer.  `--from_run` (inheriting a training run's saved
config) is not ported yet.
"""

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class TrainConfig:
    batch_size: int = 16
    seed: int = 0


def clip_shapes_from_config(cfg, modalities):
    """Per-modality single-clip shapes under this config's padding."""
    all_shapes = {"audio": (cfg.audio_samples,),
                  "text": (cfg.text_tokens, cfg.hidden_size)}
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
