"""Post-training int8 weight quantization for serving (the JAX package's
utils/quantize.py).

Weights are stored as int8 with a symmetric per-output-channel scale and
dequantized on the device at use: a 4x cut in the weights' memory and read
traffic.  The selection is the JAX package's, on the same tensors: a
parameter is quantized when it is floating point, has ndim >= 2 and at
least `min_size` elements, and its name is not one of `_SKIP_NAMES`
(lookup and bias tables, matched on the parameter's own name, never on a
module's).  In flax the output channel is a kernel's last axis; in every
port weight the bridge makes (io/from_jax.py: Linear, Conv1d/2d/3d, the
positional conv, GRU/LSTM, packed qkv) it is axis 0, so the scale is taken
over every other axis and equals the JAX scale number for number.
Rounding follows JAX: `scale = max(max|w| / 127, 1e-12)` in f32,
`round(w / scale)` half to even, clipped to +-127, and dequantization is
`q.to(dtype) * scale.to(dtype)` in that order.

Two serving modes (`quantize_model_`, `serve.Predictor(quantize=...)`):

- "int8", weight-only: every quantized weight is an int8 parameter under a
  `Dequantize` parametrization that rebuilds the float weight in the
  compute dtype at each access, inside the forward;
- "w8a8": the 2-D matmul weights of the quant-aware modules (`Linear`, the
  attention's packed `in_proj_weight`, models/layers.py) stay bare int8 with
  a `<name>_scale` buffer, and the product runs int8 x int8 -> int32 on
  dynamically quantized activations (`int8_matmul`).  `Conv1d` weights
  (2-D kernels in JAX) take the same form but are dequantized inline in
  f32 (models/nn1d.py), as the JAX Conv1d does.  RNN gate weights, 3-D to
  5-D convolutions and the wav2vec positional conv stay weight-only.

GRU and LSTM weights under a parametrization are rebuilt at each forward
and flattened into one cuDNN weight buffer there (torch's
`RNNBase.flatten_parameters`, which the RNN calls when its weights
changed).
"""

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

# Parameter names that look like kernels by shape but are lookup tables or
# additive biases (Swin's relative_position_bias_table is added to the
# attention scores directly); they stay float.
_SKIP_NAMES = ("bias_table", "embedding", "pos_embed")
MODES = ("int8", "w8a8")


class QTensor(NamedTuple):
    """A quantized weight: int8 codes in the weight's shape and the f32
    per-output-channel (axis 0) scale."""

    q: torch.Tensor
    scale: torch.Tensor


def _per_channel(scale, ndim: int):
    return scale.reshape((-1,) + (1,) * (ndim - 1))


def quantize_tensor(w) -> QTensor:
    """Symmetric per-output-channel int8 of a float weight (axis 0)."""
    w = w.detach()
    axes = tuple(range(1, w.dim()))
    scale = torch.clamp_min(w.abs().amax(dim=axes) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / _per_channel(scale, w.dim())), -127, 127)
    return QTensor(q.to(torch.int8), scale.float())


def dequantize_tensor(q, scale, dtype=torch.float32):
    """`q.to(dtype) * scale.to(dtype)`, the scale broadcast per channel."""
    return q.to(dtype) * _per_channel(scale.to(dtype), q.dim())


def _selected(name: str, w, min_size: int) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return (not any(s in leaf for s in _SKIP_NAMES)
            and isinstance(w, torch.Tensor) and w.is_floating_point()
            and w.dim() >= 2 and w.numel() >= min_size)


def quantize_params(params: Mapping[str, torch.Tensor],
                    min_size: int = 1024) -> dict:
    """{name: tensor} -> the same names, each selected weight replaced by
    its QTensor; everything else passes unchanged."""
    return {k: quantize_tensor(v) if _selected(k, v, min_size) else v
            for k, v in params.items()}


def dequantize_params(qparams: Mapping, dtype=torch.float32) -> dict:
    """The dense float weights of a `quantize_params` dict."""
    return {k: dequantize_tensor(*v, dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}


def tree_nbytes(params: Mapping) -> int:
    """Total bytes of a (possibly quantized) {name: tensor | QTensor}
    dict: a QTensor counts its int8 codes and f32 scales."""
    total = 0
    for v in params.values():
        for t in (v if isinstance(v, QTensor) else (v,)):
            total += t.numel() * t.element_size()
    return total


def _w8a8_eligible(module: nn.Module, pname: str) -> bool:
    """The JAX `_W8A8_KERNEL_NAMES` leaves with a 2-D kernel, by the port
    module that holds them: a TorchLinear `kernel` (`nn.Linear.weight`),
    the attention's `in_proj_kernel` (its `out_proj_kernel` is the port's
    `out_proj` Linear) and a Conv1d `kernel`."""
    from ..models.layers import MultiheadSelfAttention
    from ..models.nn1d import Conv1d

    return ((isinstance(module, nn.Linear) and pname == "weight")
            or (isinstance(module, MultiheadSelfAttention)
                and pname == "in_proj_weight")
            or (isinstance(module, Conv1d) and pname == "weight"))


def _owner(model: nn.Module, name: str):
    mod, _, pname = name.rpartition(".")
    return model.get_submodule(mod), pname


def split_w8a8(qparams: Mapping, model: nn.Module):
    """Split a `quantize_params` dict of `model`'s parameters into
    (params, quant) for w8a8 serving: each eligible QTensor becomes its bare
    int8 codes in `params` with its scale as `<name>_scale` in `quant`; the
    other QTensors stay (weight-only)."""
    params, quant = {}, {}
    for name, v in qparams.items():
        if isinstance(v, QTensor) and _w8a8_eligible(*_owner(model, name)):
            params[name] = v.q
            quant[name + "_scale"] = v.scale
        else:
            params[name] = v
    return params, quant


def quantize_activations(x):
    """Dynamic per-row int8 of activations (abs-max over the last axis):
    (codes int8, row scale f32 (..., 1))."""
    xf = x.float()
    amax = torch.linalg.vector_norm(xf, float("inf"), dim=-1, keepdim=True)
    xscale = torch.clamp_min(amax / 127.0, 1e-12)
    xq = (xf / xscale).round_().clamp_(-127, 127).to(torch.int8)
    return xq, xscale


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def int8_mm(a, w):
    """Exact int32 product a @ w.T of int8 a (M, K) and w (N, K) through
    `torch._int_mm`.  Its CUDA path takes M > 16 and K, N multiples of 8,
    so every operand is zero-padded (M to a multiple of 8, at least 24;
    K and N to multiples of 8) on every device, which keeps the sums exact
    and an exported graph the same on each."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, w.t())[:m, :n]


def int8_matmul(x, qweight, wscale, out_dtype=None):
    """y = x @ dequant(qweight).T as int8 x int8 -> int32: x (..., K),
    qweight (N, K) int8 (torch's Linear layout), wscale (N,) f32.  The
    activations are quantized per row on each call, and the int32 sums are
    rescaled by the row scale, then the channel scale (the JAX order)."""
    out_dtype = out_dtype or x.dtype
    xq, xscale = quantize_activations(x)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), qweight)
    acc = acc.reshape(*x.shape[:-1], qweight.shape[0])
    # (acc * row scale) * channel scale, the int32 -> f32 conversion fused
    y = torch.mul(acc, xscale).mul_(wscale.float())
    return y.to(out_dtype)


def int8_linear(x, qweight, wscale, bias=None):
    """A w8a8 Linear: `int8_matmul` in f32, the bias added, the input's
    dtype out (the JAX TorchLinear's int8 path)."""
    y = int8_matmul(x, qweight, wscale, out_dtype=torch.float32)
    if bias is not None:
        y = y.add_(bias)
    return y.to(x.dtype)


class Dequantize(nn.Module):
    """Parametrization of a weight-only int8 weight: the int8 codes in, the
    float weight in `dtype` (the compute dtype) out."""

    def __init__(self, scale, dtype=torch.float32):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q):
        return dequantize_tensor(q, self.scale, self.dtype)


def quantize_model_(model: nn.Module, mode: str, dtype=torch.float32,
                    min_size: int = 1024) -> nn.Module:
    """Quantize `model` in place for serving (see the module doc); `dtype`
    is the compute dtype the weight-only weights dequantize to."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; one of {MODES}")
    qparams = quantize_params(dict(model.named_parameters()), min_size)
    quant = {}
    if mode == "w8a8":
        qparams, quant = split_w8a8(qparams, model)
    for name, v in qparams.items():
        scale = quant.get(name + "_scale")
        if scale is None and not isinstance(v, QTensor):
            continue
        module, pname = _owner(model, name)
        delattr(module, pname)
        if scale is not None:  # w8a8: bare int8 + scale
            module.register_parameter(
                pname, nn.Parameter(v, requires_grad=False))
            module.register_buffer(pname + "_scale", scale)
        else:
            module.register_parameter(
                pname, nn.Parameter(v.q, requires_grad=False))
            parametrize.register_parametrization(
                module, pname, Dequantize(v.scale, dtype), unsafe=True)
    return model.eval()
