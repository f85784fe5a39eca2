"""Port checkpoints: one file per checkpoint, written atomically with
`torch.save`.

An inference checkpoint holds {"state_dict", "meta"}; a training
checkpoint (`save_state`) adds "optimizer" and, when an EMA is tracked,
"ema" ({"decay", "params"}: the shadow of the trainable parameters), so
any training checkpoint also serves (`restore_variables`, which hands out
the EMA shadow in place of the live parameters, as the JAX package's
`eval_params`; `cli/serve.py --path_to_checkpoint`).  The JAX package's
orbax checkpoints are not read here: `orbax.checkpoint` imports jax, which
the port never imports; convert JAX variables with io/from_jax.py
instead.

On a data- or tensor-parallel mesh (`state.mesh`) every rank calls
`save_state`: the payload is gathered into the unsharded layout (a
collective over the tp group), rank 0 writes it, and every rank waits at
a barrier after the write.  Every rank restores the whole file and cuts
its shards again, so a checkpoint carries no trace of its layout and a
run resumes under any other.
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
    """Inference restore: returns (state_dict on the CPU, meta), the EMA
    shadow in place of the trained parameters when the checkpoint has
    one."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = dict(ckpt["state_dict"])
    if ckpt.get("ema"):
        state_dict.update(ckpt["ema"]["params"])
    return state_dict, ckpt["meta"]


def save_state(path: str, state, meta: dict | None = None, extra=None):
    """A training checkpoint of `state` (train/state.TrainState): the
    model's weights and buffers, the optimizer's state, the EMA shadow and
    `meta` (epoch, best errors, ...); `extra` ({name: tensors}) rides
    along (a preemption checkpoint's random-generator state)."""
    payload = {"state_dict": _cpu(state.model.state_dict()),
               "optimizer": state.optimizer.state_dict(),
               "meta": dict(meta or {})}
    if state.ema is not None:
        payload["ema"] = {"decay": state.ema_decay,
                          "params": _cpu(state.ema)}
    payload.update(extra or {})
    mesh = getattr(state, "mesh", None)
    if mesh is None:
        _write(path, payload)
        return
    from ..parallel.mesh import barrier
    from ..parallel.sharding_rules import gather_state

    if mesh.tp > 1:
        payload = gather_state(payload, state)
    if mesh.is_main:
        _write(path, payload)
    barrier()


def restore_state(path: str, state) -> dict:
    """Load a training checkpoint into `state`: the model strictly, the
    optimizer's moments and counters (moved to the parameters' device), and
    the EMA.  A shadow in the checkpoint is restored with its saved decay,
    also into a state that tracks none (a resume that forgot --ema_decay
    keeps tracking); a state that tracks one and a checkpoint without seed
    the shadow from the restored parameters.  An optimizer state that does
    not fit this optimizer (another set of trained parameters) is left
    fresh, with a note in the returned meta (the JAX package's rule).
    Returns (meta, the payload's extras of save_state)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    mesh = getattr(state, "mesh", None)
    if mesh is not None and mesh.tp > 1:
        from ..parallel.sharding_rules import place_state_for_tp

        ckpt = place_state_for_tp(ckpt, state)
    state.model.load_state_dict(ckpt["state_dict"], strict=True)
    meta = dict(ckpt["meta"])
    try:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    except (ValueError, KeyError, IndexError) as e:
        meta["optimizer_state"] = (f"reinitialized: the checkpoint's "
                                   f"optimizer state does not fit ({e})")
    ema = ckpt.get("ema")
    if ema:
        state.start_ema(ema["decay"] if state.ema is None
                        else state.ema_decay, ema["params"])
    elif state.ema is not None:
        state.start_ema(state.ema_decay)
    known = {"state_dict", "optimizer", "meta", "ema"}
    return meta, {k: v for k, v in ckpt.items() if k not in known}
