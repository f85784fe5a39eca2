"""Port checkpoints: one file holding `torch.save({"state_dict", "meta"})`.

Reading the JAX package's orbax checkpoints is not ported (it needs orbax);
convert JAX variables with io/from_jax.py instead.
"""

import os

import torch


def save_variables(path: str, state_dict: dict, meta: dict | None = None):
    """Write `state_dict` (tensors moved to the CPU) and `meta` to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "meta": dict(meta or {})}, tmp)
    os.replace(tmp, path)


def restore_variables(path: str):
    """Inference restore: returns (state_dict on the CPU, meta)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["state_dict"], ckpt["meta"]
