"""Mixed precision (the JAX package's utils/precision.py): bf16 compute with
f32 master parameters.

A train or eval step under `compute_dtype="bfloat16"` keeps the master
parameters, the optimizer state, the gradients, the BatchNorm running
statistics, the losses and the metrics in float32; inside the step it casts
the floating parameters and the modality inputs to bfloat16 and runs the
model on the casts (train/steps.py, serve.Predictor).  The cast is
differentiable, so the gradients land on the f32 masters.  Normalization
statistics and softmaxes run in float32 inside the layers (models/nn1d.py,
models/layers.py), as in the JAX package.
"""

import torch

_DTYPES = {
    None: None,
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_dtype(spec):
    """'bf16' / 'bfloat16' / 'f32' / 'float32' / None or a torch dtype ->
    torch dtype or None; unknown names raise ValueError."""
    if isinstance(spec, str):
        try:
            return _DTYPES[spec.lower()]
        except KeyError:
            raise ValueError(f"unknown compute dtype {spec!r}") from None
    if spec is None or isinstance(spec, torch.dtype):
        return spec
    raise ValueError(f"unknown compute dtype {spec!r}")


def cast_floating(tree, dtype):
    """Cast the floating-point tensors of nested dicts (or a tensor) to
    `dtype`; integer and bool tensors, and anything else, pass unchanged.
    The tree itself is returned when dtype resolves to None."""
    dtype = resolve_dtype(dtype)
    if dtype is None:
        return tree

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.dtype != dtype):
            return x.to(dtype)
        return x

    return cast(tree)
