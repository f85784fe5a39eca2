"""JAX variables -> port state_dict: the weight bridge between the packages.

The inverse of the JAX package's io/torch_import.py, for the modules the
port has.  Input is the JAX `{"params", "batch_stats"}` tree with numpy
leaves (`jax.tree.map(np.asarray, variables)`); output is a state_dict for
the port module of the same architecture.  Layout rules:

- Linear:     kernel (in, out)         -> weight (out, in)
- Conv1d:     kernel (K*C_in, C_out)   -> weight (C_out, C_in, K); C_in is
              1 for `conv0` and the previous conv's C_out after it (the
              CNN1D trunk's chain)
- MHA:        in_proj_kernel (E, 3E)   -> in_proj_weight (3E, E);
              out_proj_kernel/_bias    -> out_proj.weight (transposed)/.bias
- Norms:      scale -> weight; BN batch_stats mean/var -> running_mean/_var
- Names:      flax's `extractors_<m>` and `layers_<i>` -> `extractors.<m>`,
              `layers.<i>` (ModuleDict / ModuleList)

A leaf no rule consumes raises, and `load_jax_variables` loads with
strict=True, so a port parameter or buffer left unfilled raises too.
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

_RENAMES = ((re.compile(r"^extractors_(\w+)$"), r"extractors.\1"),
            (re.compile(r"^layers_(\d+)$"), r"layers.\1"))


def _module_path(path):
    out = []
    for seg in path:
        for pat, repl in _RENAMES:
            if pat.match(seg):
                seg = pat.sub(repl, seg)
                break
        out.append(seg)
    return "".join(seg + "." for seg in out)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _conv_in_channels(params_at, path):
    """C_in of conv{i}: 1 for conv0, else conv{i-1}'s C_out."""
    i = int(path[-1][len("conv"):])
    if i == 0:
        return 1
    prev = params_at(path[:-1] + (f"conv{i - 1}",))
    return prev["kernel"].shape[1]


def from_jax_variables(variables) -> dict:
    """{"params", "batch_stats"} numpy tree -> {name: torch.Tensor}."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unconsumed JAX collections {sorted(extra)}")
    params = variables["params"]

    def params_at(path):
        node = params
        for seg in path:
            node = node[seg]
        return node

    sd = {}
    for path, value in _flatten(params):
        mod, leaf = _module_path(path[:-1]), path[-1]
        if (leaf == "kernel" and len(path) > 1
                and re.fullmatch(r"conv\d+", path[-2])):
            c_in = _conv_in_channels(params_at, path[:-1])
            k = value.shape[0] // c_in
            if k * c_in != value.shape[0]:
                raise ValueError(f"{'/'.join(path)}: kernel rows "
                                 f"{value.shape[0]} not a multiple of C_in {c_in}")
            sd[f"{mod}weight"] = value.reshape(k, c_in, -1).transpose(2, 1, 0)
        elif leaf == "kernel":
            sd[f"{mod}weight"] = value.T
        elif leaf in ("bias", "in_proj_bias"):
            sd[f"{mod}{leaf}"] = value
        elif leaf == "scale":
            sd[f"{mod}weight"] = value
        elif leaf == "in_proj_kernel":
            sd[f"{mod}in_proj_weight"] = value.T
        elif leaf == "out_proj_kernel":
            sd[f"{mod}out_proj.weight"] = value.T
        elif leaf == "out_proj_bias":
            sd[f"{mod}out_proj.bias"] = value
        else:
            raise ValueError(f"unconsumed JAX leaf params/{'/'.join(path)}")
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in stat_names:
            raise ValueError(
                f"unconsumed JAX leaf batch_stats/{'/'.join(path)}")
        sd[f"{_module_path(path[:-1])}{stat_names[path[-1]]}"] = value
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into `model` (strict: every parameter and buffer
    must be filled, and nothing may be left over)."""
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model
