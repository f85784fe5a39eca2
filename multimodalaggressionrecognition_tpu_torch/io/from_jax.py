"""JAX variables -> port state_dict: the weight bridge between the packages.

The inverse of the JAX package's io/torch_import.py, for the modules the
port has.  Input is the JAX `{"params", "batch_stats"}` tree with numpy
leaves (`jax.tree.map(np.asarray, variables)`); output is a state_dict for
the port module of the same architecture.  Layout rules:

- Linear:     kernel (in, out)         -> weight (out, in)
- Conv1d:     kernel (K*C_in, C_out)   -> weight (C_out, C_in, K); C_in is
              1 for `conv0` and the previous conv's C_out after it (the
              CNN1D trunk's chain)
- Conv2d:     kernel (kh, kw, C_in, C_out) -> weight (C_out, C_in, kh, kw)
- Conv3d:     kernel (kt, kh, kw, C_in, C_out)
                                       -> weight (C_out, C_in, kt, kh, kw)
              (both told from a Conv1d by their rank, before the Conv1d
              rule: the VGG names its convs conv{i}, and R3D's blocks
              conv1 and conv2)
- Pos. conv:  pos_conv/kernel (K, E/g, E) -> weight (E, E/g, K)
- GRU, LSTM:  kernel_ih (E, 3H|4H), kernel_hh (H, 3H|4H)
                                       -> weight_ih_l0, weight_hh_l0
              (transposed); bias_ih, bias_hh -> bias_ih_l0, bias_hh_l0
- Swin:       relative_position_bias_table (entries, heads) kept as it is
- MHA:        in_proj_kernel (E, 3E)   -> in_proj_weight (3E, E);
              out_proj_kernel/_bias    -> out_proj.weight (transposed)/.bias
- Norms:      scale -> weight; BN batch_stats mean/var -> running_mean/_var
- Names:      flax's `extractors_<m>`, `heads_<name>`, `classifiers_<m>`
              and `layers_<i>` -> `extractors.<m>`, `heads.<name>`,
              `classifiers.<m>`, `layers.<i>` (ModuleDict / ModuleList);
              the tri-modal video
              tower's auto-named `Swin3dTExtractor_0` (its frozen backbone)
              -> `backbone`, the port's WindowedVideoExtractor attribute
- Per model:  a port module whose JAX twin files a submodule elsewhere
              declares `jax_renames`, (prefix, replacement) pairs applied to
              the converted names' leading part; `load_jax_variables` reads
              them from the module, `from_jax_variables` takes them as an
              argument

A leaf no rule consumes raises, and `load_jax_variables` loads with
strict=True, so a port parameter or buffer left unfilled raises too.
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

_RENAMES = ((re.compile(r"^extractors_(\w+)$"), r"extractors.\1"),
            (re.compile(r"^heads_(\w+)$"), r"heads.\1"),
            (re.compile(r"^classifiers_(\w+)$"), r"classifiers.\1"),
            (re.compile(r"^layers_(\d+)$"), r"layers.\1"),
            (re.compile(r"^Swin3dTExtractor_\d+$"), "backbone"))


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


def _renamed(name, renames):
    for prefix, repl in renames:
        if name.startswith(prefix):
            return repl + name[len(prefix):]
    return name


def from_jax_variables(variables, renames=()) -> dict:
    """{"params", "batch_stats"} numpy tree -> {name: torch.Tensor}.

    `renames`: the target module's `jax_renames` (see the module doc)."""
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
        # by the kernel's rank first: the VGG's 2-D convs and the R3D
        # blocks' 3-D convs are named conv{i} too, and must not take the
        # CNN1D trunk's Conv1d rule
        if leaf == "kernel" and value.ndim == 4:
            sd[f"{mod}weight"] = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 5:
            sd[f"{mod}weight"] = value.transpose(4, 3, 0, 1, 2)
        elif (leaf == "kernel" and len(path) > 1
                and re.fullmatch(r"conv\d+", path[-2])):
            c_in = _conv_in_channels(params_at, path[:-1])
            k = value.shape[0] // c_in
            if k * c_in != value.shape[0]:
                raise ValueError(f"{'/'.join(path)}: kernel rows "
                                 f"{value.shape[0]} not a multiple of C_in {c_in}")
            sd[f"{mod}weight"] = value.reshape(k, c_in, -1).transpose(2, 1, 0)
        elif leaf == "kernel" and path[-2:-1] == ("pos_conv",):
            sd[f"{mod}weight"] = value.transpose(2, 1, 0)
        elif leaf in ("kernel_ih", "kernel_hh"):
            sd[f"{mod}weight_{leaf[-2:]}_l0"] = value.T
        elif leaf in ("bias_ih", "bias_hh"):
            sd[f"{mod}{leaf}_l0"] = value
        elif leaf == "kernel":
            sd[f"{mod}weight"] = value.T
        elif leaf in ("bias", "in_proj_bias", "relative_position_bias_table"):
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
    return {_renamed(k, renames): torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into `model` (strict: every parameter and buffer
    must be filled, and nothing may be left over)."""
    model.load_state_dict(from_jax_variables(
        variables, getattr(model, "jax_renames", ())), strict=True)
    return model
