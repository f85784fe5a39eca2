"""Inference-time BatchNorm folding for conv trunks (the JAX package's
utils/fold_bn.py).

For eval-mode Conv -> BN -> ReLU chains, BN is an affine map with frozen
statistics and folds into the convolution:
    k = gamma / sqrt(var + eps)
    w' = w * k        (per output channel)
    b' = (b - mean) * k + beta
After folding, the CNN1D stem's kernel epilogue (ops/cuda/framed_conv.py)
needs no scale or shift, and each conv drops its normalization.  The
port's eval forward already folds each BatchNorm into its conv's epilogue
at run time (models/cnn1d.py); this folds the weights once, for
`CNN1DExtractor(folded=True)`, which has no BatchNorm modules.
"""

import torch


def fold_conv_bn(weight, bias, bn_weight, bn_bias, mean, var,
                 eps: float = 1e-5):
    """Fold one BatchNorm into a conv's weight (C_out first: Conv1d's
    (C_out, C_in, K), ConvNd's (C_out, C_in, *K)) and bias (None: zero).
    Returns (weight, bias)."""
    k = bn_weight / torch.sqrt(var + eps)
    folded = weight * k.reshape((-1,) + (1,) * (weight.dim() - 1))
    if bias is None:
        bias = torch.zeros_like(mean)
    return folded, (bias - mean) * k + bn_bias


def fold_cnn1d_variables(state_dict, prefix: str = "",
                         eps: float = 1e-5) -> dict:
    """A CNN1DExtractor state_dict (under `prefix`, e.g. "extractor." in a
    CNN1D or an AudioCnn1DExtractorWrapper) -> the state_dict of the
    `folded=True` variant: every conv{i} folded with bn{i}, the bn{i}
    entries dropped."""
    out = dict(state_dict)
    i = 0
    while f"{prefix}conv{i}.weight" in state_dict:
        conv, bn = f"{prefix}conv{i}.", f"{prefix}bn{i}."
        out[conv + "weight"], out[conv + "bias"] = fold_conv_bn(
            state_dict[conv + "weight"], state_dict.get(conv + "bias"),
            state_dict[bn + "weight"], state_dict[bn + "bias"],
            state_dict[bn + "running_mean"], state_dict[bn + "running_var"],
            eps)
        for name in ("weight", "bias", "running_mean", "running_var"):
            del out[bn + name]
        i += 1
    return out
