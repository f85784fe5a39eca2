"""Placing a model and its training state on a (dp x tp) mesh (the JAX
package's parallel/sharding_rules.py).

Megatron's rules for the transformer blocks, with the port's names
(torch weights are (out, in), so JAX's column-parallel kernel is split by
rows here):

- attention `in_proj_weight` / `in_proj_bias`: split by output rows, BY
  HEAD: rank r holds heads [r h / tp, (r + 1) h / tp) of q, k and v;
- attention `out_proj.weight`: split by input columns (the same heads);
- MLP `linear1.weight` / `linear1.bias`: split by output rows;
- MLP `linear2.weight`: split by input columns;
- everything else, the biases of `out_proj` and `linear2` included
  (added once, after the reduce), replicated.

JAX's `P(None, 'model')` on the (E, 3E) in-projection cuts the 3E axis
into contiguous halves, which puts all of q and half of k on rank 0:
GSPMD reshards that for free, a hand-written layer cannot, so the port
splits by head.  The rules apply to the modules whose forward runs on
shards (models/layers.py `MultiheadSelfAttention` and
`TransformerEncoderLayer`, which wav2vec and the fusion encoder reuse); a
module whose heads or feed-forward width does not divide by tp stays
replicated whole (JAX's rule per leaf, `sharding_rules.py:40-57`).

Checkpoints hold the unsharded layout (`gather_state`), in JAX's row
order, so a run resumes under any layout and `io/from_jax.py` reads the
same tree.

Serving splits in one process (`place_params_local`, the JAX package's
`Predictor(param_placement=place_params)`): the same rules cut each split
module's weights into one contiguous shard per device of a data group.  A
weight-only int8 weight is quantized whole first and its codes are split
with their per-row scales (cut with the rows of a row split, whole for a
column split), so every shard dequantizes to the whole weight's values.
w8a8 weights stay whole: their per-row activation scales would change
under a column split.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .mesh import Mesh, all_reduce_


@dataclass(frozen=True)
class Split:
    """A parameter split over the tp group along `dim` (0: output rows,
    1: input columns); with `blocks` 3 each of q, k and v is split alike."""

    dim: int
    blocks: int = 1


def transformer_tp_shardings(model: nn.Module, tp: int
                             ) -> Dict[str, Optional[Split]]:
    """{parameter name: Split or None (replicated)} of `model` for tp
    ranks."""
    from ..models.layers import MultiheadSelfAttention, TransformerEncoderLayer

    out = {name: None for name, _ in model.named_parameters()}
    if tp <= 1:
        return out
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, MultiheadSelfAttention) and attention_splits(m, tp):
            out[p + "in_proj_weight"] = Split(0, 3)
            out[p + "in_proj_bias"] = Split(0, 3)
            out[p + "out_proj.weight"] = Split(1)
        elif isinstance(m, TransformerEncoderLayer) and ff_splits(m, tp):
            out[p + "linear1.weight"] = Split(0)
            out[p + "linear1.bias"] = Split(0)
            out[p + "linear2.weight"] = Split(1)
    return out


def attention_splits(m, tp: int) -> bool:
    return m.num_heads % tp == 0 and m.in_proj_weight.dtype != torch.int8


def ff_splits(m, tp: int) -> bool:
    return (m.linear1.out_features % tp == 0
            and m.linear1.weight.dtype != torch.int8)


def _spans(size: int, split: Split, rank: int, tp: int):
    """(start, length) of rank's pieces along the split dim of a full
    tensor `size` long."""
    block = size // split.blocks
    per = block // tp
    return [(b * block + rank * per, per) for b in range(split.blocks)]


def shard_tensor(full, split: Split, rank: int, tp: int):
    """Rank's shard of the unsharded tensor `full`."""
    return torch.cat([full.narrow(split.dim, s, n) for s, n
                      in _spans(full.shape[split.dim], split, rank, tp)],
                     dim=split.dim).contiguous()


def gather_tensor(local, split: Split, mesh: Mesh):
    """The unsharded tensor from every tp rank's shard (a sum of zero-padded
    shards: exact, and an all-reduce, which gloo also runs on CUDA)."""
    shape = list(local.shape)
    shape[split.dim] *= mesh.tp
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    offset = 0
    for s, n in _spans(shape[split.dim], split, mesh.tp_rank, mesh.tp):
        full.narrow(split.dim, s, n).copy_(local.narrow(split.dim, offset, n))
        offset += n
    return all_reduce_(full, mesh.tp_group)


def model_splits(model: nn.Module) -> Dict[str, Split]:
    """{name: Split} of the parameters `place_params` has split."""
    return {name: p.tp_split for name, p in model.named_parameters()
            if getattr(p, "tp_split", None) is not None}


def place_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place `model` (unsharded, on mesh.device) on the mesh, in place:
    under tp > 1 split the transformer parameters (above) and run their
    modules on shards; every BatchNorm takes its batch statistics over the
    data group (of more than one rank); every random module draws its mask
    for the global batch and keeps this rank's rows
    (models/stochastic.py)."""
    from ..models.layers import MultiheadSelfAttention, TransformerEncoderLayer
    from ..models.nn1d import BatchNorm1d
    from ..models.stochastic import Random

    splits = transformer_tp_shardings(model, mesh.tp)
    params = dict(model.named_parameters())
    for name, split in splits.items():
        if split is None:
            continue
        p = params[name]
        p.data = shard_tensor(p.data, split, mesh.tp_rank, mesh.tp)
        p.tp_split = split
    tp = (mesh.tp_group, mesh.tp_rank, mesh.tp)
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, MultiheadSelfAttention):
            if splits.get(p + "in_proj_weight") is not None:
                m.tp = tp
        elif isinstance(m, TransformerEncoderLayer):
            if splits.get(p + "linear1.weight") is not None:
                m.tp = tp
        if isinstance(m, BatchNorm1d) and mesh.dp > 1:
            m.data_group = mesh.dp_group  # one data rank: its own batch
        if isinstance(m, Random):
            m.batch_shard = (mesh.dp_rank, mesh.dp)
    return model


class Shard(nn.Module):
    """One device's pieces of a split module: each split parameter of it
    (`splits`: {name: Split}) under its name with "_" for ".", a
    weight-only int8 one under its `Dequantize`."""

    def __init__(self, splits: Dict[str, Split]):
        super().__init__()
        self.splits = splits


def _take(module: nn.Module, name: str):
    """(values, Dequantize or None) of `module`'s parameter `name`: a
    weight-only int8 weight's codes and dequantization, else the tensor;
    the module's own reference is dropped."""
    from torch.nn.utils import parametrize

    owner_name, _, pname = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    dequantize = None
    if parametrize.is_parametrized(owner, pname):
        # a deep copy shares its parametrized class with the original, and
        # the removal deletes the weight's property from the class: give
        # this module a class of its own first
        cls = type(owner)
        owner.__class__ = type(cls.__name__, cls.__bases__, {
            k: v for k, v in vars(cls).items()
            if k not in ("__dict__", "__weakref__")})
        dequantize = owner.parametrizations[pname][0]
        parametrize.remove_parametrizations(owner, pname,
                                            leave_parametrized=False)
    values = getattr(owner, pname).detach()
    setattr(owner, pname, None)
    return values, dequantize


def _local_shard(pieces, splits, rank: int, tp: int, device) -> Shard:
    from torch.nn.utils import parametrize

    from ..utils.quantize import Dequantize

    shard = Shard(splits)
    for name, (values, dequantize) in pieces.items():
        split = splits[name]
        attr = name.replace(".", "_")
        shard.register_parameter(attr, nn.Parameter(
            shard_tensor(values, split, rank, tp).to(device),
            requires_grad=False))
        if dequantize is not None:
            scale = dequantize.scale
            if split.dim == 0:  # a row's scale goes with the row
                scale = shard_tensor(scale, split, rank, tp)
            parametrize.register_parametrization(
                shard, attr, Dequantize(scale.to(device), dequantize.dtype),
                unsafe=True)
    return shard


def place_params_local(model: nn.Module, devices) -> nn.Module:
    """Place `model` (unsharded, possibly quantized) over the devices of
    one data group in one process, in place, tp = len(devices): the
    replicated parameters on the first device, and each module the rules
    split given `tp_shards`, one `Shard` a device in rank order, its whole
    split weights freed.  The cuts are `place_params`'."""
    from ..models.layers import MultiheadSelfAttention, TransformerEncoderLayer

    split_names = ((MultiheadSelfAttention,
                    ("in_proj_weight", "in_proj_bias", "out_proj.weight")),
                   (TransformerEncoderLayer,
                    ("linear1.weight", "linear1.bias", "linear2.weight")))
    devices = [torch.device(d) for d in devices]
    tp = len(devices)
    splits = transformer_tp_shardings(model, tp)
    model.to(devices[0])
    for prefix, m in list(model.named_modules()):
        p = f"{prefix}." if prefix else ""
        names = next((n for cls, n in split_names if isinstance(m, cls)), ())
        if not names or splits.get(p + names[0]) is None:
            continue
        pieces = {n: _take(m, n) for n in names}
        own = {n: splits[p + n] for n in names}
        m.tp_shards = nn.ModuleList(_local_shard(pieces, own, r, tp, d)
                                    for r, d in enumerate(devices))
    return model


def local_splits(model: nn.Module) -> Dict[str, Split]:
    """{name: Split} of the parameters `place_params_local` has split."""
    return {(f"{prefix}." if prefix else "") + n: s
            for prefix, m in model.named_modules()
            if getattr(m, "tp_shards", None) is not None
            for n, s in m.tp_shards[0].splits.items()}


def _optimizer_names(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def _map_state(payload, state, fn):
    """`payload` (a checkpoint's {"state_dict", "optimizer", "ema"}) with
    fn(tensor, split) applied to every tensor shaped like a split
    parameter: the weights, the Adam moments, the accumulated gradients
    and the EMA shadow."""
    splits = model_splits(state.model)
    if not splits:
        return payload
    out = dict(payload)

    def by_name(tree):
        return {k: (fn(v, splits[k]) if k in splits else v)
                for k, v in tree.items()}

    out["state_dict"] = by_name(payload["state_dict"])
    if payload.get("ema"):
        out["ema"] = dict(payload["ema"], params=by_name(
            payload["ema"]["params"]))
    opt = payload.get("optimizer")
    if opt is not None:
        names = _optimizer_names(state)
        opt = dict(opt)
        adam = dict(opt["adam"])
        adam["state"] = {
            i: {k: (fn(v, splits[names[i]])
                    if names[i] in splits and k != "step" else v)
                for k, v in s.items()}
            for i, s in opt["adam"]["state"].items()}
        opt["adam"] = adam
        if opt.get("accumulation"):
            opt["accumulation"] = dict(opt["accumulation"], grads=[
                fn(g, splits[n]) if n in splits else g
                for g, n in zip(opt["accumulation"]["grads"], names)])
        out["optimizer"] = opt
    return out


def gather_state(payload, state):
    """The checkpoint payload of this rank's shards in the unsharded
    layout, JAX's row order (a collective over the tp group)."""
    mesh = state.mesh
    return _map_state(payload, state,
                      lambda t, s: gather_tensor(t.to(mesh.device), s, mesh
                                                 ).cpu())


def place_state_for_tp(payload, state):
    """The inverse: an unsharded checkpoint payload cut to this rank's
    shards, each moment, accumulator and shadow as its parameter."""
    mesh = state.mesh
    return _map_state(payload, state,
                      lambda t, s: shard_tensor(t, s, mesh.tp_rank, mesh.tp))


def clip_norm_squares(grads, params, mesh: Optional[Mesh]):
    """The squared global norm of `grads` under tp: the split leaves'
    squares summed over the tp group, each replicated leaf once."""
    split = [g for g, p in zip(grads, params)
             if getattr(p, "tp_split", None) is not None]
    whole = [g for g, p in zip(grads, params)
             if getattr(p, "tp_split", None) is None]
    zero = grads[0].new_zeros((), dtype=torch.float32)
    sq = sum((g.float().square().sum() for g in whole), zero)
    if split:
        part = sum((g.float().square().sum() for g in split), zero)
        sq = sq + all_reduce_(part, mesh.tp_group)
    return sq
