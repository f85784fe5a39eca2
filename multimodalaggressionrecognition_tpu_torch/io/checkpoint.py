"""Port checkpoints: one file per checkpoint, written atomically with
`torch.save`.

An inference checkpoint holds {"state_dict", "meta"}; a training
checkpoint (`save_state`) adds "optimizer", so any training checkpoint also
serves (`restore_variables`, `cli/serve.py --path_to_checkpoint`).
Reading the JAX package's orbax checkpoints is not ported (it needs orbax);
convert JAX variables with io/from_jax.py instead.
"""

import os

import torch


def _write(path: str, payload: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader sees the old file or the new, whole


def _cpu(state_dict):
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_variables(path: str, state_dict: dict, meta: dict | None = None):
    """Write `state_dict` (tensors moved to the CPU) and `meta` to `path`."""
    _write(path, {"state_dict": _cpu(state_dict), "meta": dict(meta or {})})


def restore_variables(path: str):
    """Inference restore: returns (state_dict on the CPU, meta)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["state_dict"], ckpt["meta"]


def save_state(path: str, model, optimizer, meta: dict | None = None):
    """A training checkpoint: the model's weights and buffers, the
    optimizer's state and `meta` (epoch, best errors, ...)."""
    _write(path, {"state_dict": _cpu(model.state_dict()),
                  "optimizer": optimizer.state_dict(),
                  "meta": dict(meta or {})})


def restore_state(path: str, model, optimizer) -> dict:
    """Load a training checkpoint into `model` (strictly) and `optimizer`
    (moved to the parameters' device); returns its meta."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["meta"]
