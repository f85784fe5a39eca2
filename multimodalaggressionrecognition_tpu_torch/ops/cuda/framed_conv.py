"""Framed conv1d: the CNN1D stem's kernel (csrc/framed_conv.cu) and its
plain PyTorch version.

The port of `framed_conv1d_pallas` (JAX package,
ops/pallas/framed_conv.py): a strided conv over a (B, L) single-channel
signal with weight (F, C_out), giving (B, T, C_out), with an optional
per-channel scale/shift epilogue (folded inference BatchNorm) and ReLU.
The TPU-only lane-packing variant (`framed_conv1d_grouped`) is not ported:
it is the same function with redundant FLOPs.

The kernel is an implicit GEMM on the tensor cores (frames x taps times
taps x channels, mma.sync in f32-accurate 3xTF32): each block gathers its
frames straight from the unpadded signal into shared memory, 32 taps at a
time and double-buffered, so neither the padded copy nor the frame matrix
reaches device memory; the epilogue folds bias, scale, shift and ReLU.
A block owns 64 frames, or 128 where the taps are many and the grid is
full (the STFT, the resample at b32).  Its sums run in the same fixed order
either way, so two launches agree bit for bit.  On an NVIDIA H100 80GB HBM3
at 700 W (chip_smoke.py) it takes about 0.046 ms at the CNN1D stem (B=32,
80 000 samples, F=160, hop 40, C=64) against F.conv1d's 0.11, and 0.12 ms
at the STFT's basis (F=512, hop 256, C=514) against 0.32: 17 % and 26 % of
the tensor cores' bound.

`framed_conv1d` calls the `mar_torch::framed_conv1d` op (torch.library):
its CPU implementation is the plain version, its CUDA one launches the
kernel (counted by `utils/kernels.launch`), and its fake one gives the
output's shape and dtype, so torch.export keeps the op whole in a serving
artifact's graph (io/export.py).

`framed_conv1d_trainable` is the differentiable entry (the JAX custom VJP
`framed_conv1d`): its forward is `framed_conv1d` with the bias only, and its
backward the JAX package's XLA formula in torch ops
(`framed_conv1d_backward`), as no TPU kernel computes it.  The epilogue
(scale, shift, ReLU) is for inference only.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.kernels import check_tensor, launch, load_library, query
from ..framing import framed_matmul

# framed_conv1d_f32: x, w, bias, scale, shift, y, B, L, F, C, T, hop, pad,
# relu; framed_conv1d_info: m_tiles, out[3]
_SIGNATURES = {"framed_conv1d_f32": "PPPPPPiiiiiiii",
               "framed_conv1d_info": "io"}


def launch_info(m_tiles: int) -> dict:
    """The launch of the kernel's tile with `m_tiles` (1 or 2) 16-frame
    m-tiles a warp on the current card (one shape for every C): threads per
    block, dynamic shared memory bytes, resident blocks per SM."""
    out = query(load_library("framed_conv", _SIGNATURES),
                "framed_conv1d_info", m_tiles, n_out=3)
    return dict(zip(("threads", "dynamic_smem_bytes", "blocks_per_sm"), out))


def out_length(length: int, kernel_size: int, stride: int, pad: int) -> int:
    return (length + 2 * pad - kernel_size) // stride + 1


def framed_conv1d_reference(x, weight, bias, kernel_size: int, stride: int,
                            pad: int = 0, scale=None, shift=None,
                            relu: bool = False):
    """The plain version: frame the padded signal, then one matmul."""
    y = framed_matmul(x[..., None], weight, bias, kernel_size, stride, pad)
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    return torch.relu(y) if relu else y


def framed_conv1d(x, weight, bias, kernel_size: int, stride: int, pad: int = 0,
                  scale=None, shift=None, relu: bool = False):
    """x (B, L) f32, weight (F, C_out), bias (C_out,), optional scale/shift
    (C_out,) -> (B, T, C_out): the `mar_torch::framed_conv1d` op.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"framed_conv1d: no kernel for device {x.device}")
    return torch.ops.mar_torch.framed_conv1d(
        x, weight, bias, kernel_size, stride, pad, scale, shift, relu)


@torch.library.custom_op("mar_torch::framed_conv1d", mutates_args=(),
                         device_types="cpu")
def _framed_conv1d_op(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, kernel_size: int, stride: int,
                      pad: int, scale: Optional[torch.Tensor],
                      shift: Optional[torch.Tensor],
                      relu: bool) -> torch.Tensor:
    return framed_conv1d_reference(x, weight, bias, kernel_size, stride, pad,
                                   scale, shift, relu)


@_framed_conv1d_op.register_fake
def _(x, weight, bias, kernel_size, stride, pad, scale, shift, relu):
    b, length = x.shape
    return x.new_empty((b, out_length(length, kernel_size, stride, pad),
                        weight.shape[-1]))


@_framed_conv1d_op.register_kernel("cuda")
def _framed_conv1d_cuda(x, weight, bias, kernel_size, stride, pad, scale,
                        shift, relu):
    if x.dim() != 2:
        raise ValueError(f"framed_conv1d: x must be (B, L), got {tuple(x.shape)}")
    b, length = x.shape
    c_out = weight.shape[-1]
    for name, t, shape in (("x", x, (b, length)),
                           ("weight", weight, (kernel_size, c_out)),
                           ("bias", bias, (c_out,))):
        check_tensor("framed_conv1d", name, t, shape, torch.float32, x.device)
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None:
            check_tensor("framed_conv1d", name, t, (c_out,), torch.float32,
                         x.device)
    t_out = out_length(length, kernel_size, stride, pad)
    if t_out <= 0 or stride <= 0 or pad < 0 or b <= 0:
        raise ValueError(f"framed_conv1d: unsupported shape B={b} L={length} "
                         f"F={kernel_size} hop={stride} pad={pad}")
    if length + 2 * pad >= 2 ** 31:  # the kernel's sizes are 32-bit ints
        raise ValueError("framed_conv1d: signals of 2**31 samples or more "
                         "are not supported")
    if -(-b * t_out // 128) * 128 >= 2 ** 31:  # frames in whole 128-frame tiles
        raise ValueError("framed_conv1d: 2**31 output frames or more are not "
                         "supported")
    y = torch.empty((b, t_out, c_out), dtype=torch.float32, device=x.device)
    launch(load_library("framed_conv", _SIGNATURES), "framed_conv1d_f32",
           "framed_conv1d", x.device, x, weight, bias, scale, shift, y, b,
           length, kernel_size, c_out, t_out, stride, pad, int(relu))
    return y


def framed_conv1d_backward(x, weight, g, kernel_size: int, stride: int,
                           pad: int = 0):
    """Gradients (dx, dW, dbias) of framed_conv1d for output gradient g
    (B, T, C_out).  With rows = pad(x) cut into (rows, hop) and the weight
    cut into hop-row slabs W_k: d_rows[t+k] += g[t] W_k^T and
    dW_k = rows[t+k]^T g; dx is d_rows cut back to the unpadded signal."""
    b, length = x.shape
    c_out = weight.shape[1]
    t_out = g.shape[1]
    n_shift = -(-kernel_size // stride)
    rows_needed = t_out + n_shift - 1
    total = rows_needed * stride
    xp = F.pad(x, (pad, max(0, total - length - pad)))[:, :total]
    rows = xp.reshape(b, rows_needed, stride)
    w_slabs = F.pad(weight, (0, 0, 0, n_shift * stride - kernel_size)
                    ).reshape(n_shift, stride, c_out)
    d_rows = torch.zeros_like(rows)
    dw_slabs = []
    g2 = g.reshape(b * t_out, c_out)
    for k in range(n_shift):
        d_rows[:, k:k + t_out] += g @ w_slabs[k].T
        dw_slabs.append(rows[:, k:k + t_out].reshape(b * t_out, stride).T
                        @ g2)
    d_weight = torch.cat(dw_slabs)[:kernel_size]
    dx = d_rows.reshape(b, -1)[:, pad:pad + length]
    if dx.shape[1] < length:  # the tail past the last frame got no gradient
        dx = F.pad(dx, (0, length - dx.shape[1]))
    return dx, d_weight, g.sum(dim=(0, 1))


class _FramedConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, kernel_size, stride, pad):
        ctx.save_for_backward(x, weight)
        ctx.conv = (kernel_size, stride, pad)
        return framed_conv1d(x, weight, bias, kernel_size, stride, pad)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = framed_conv1d_backward(x, weight, g, *ctx.conv)
        return dx, dw, db, None, None, None


def framed_conv1d_trainable(x, weight, bias, kernel_size: int, stride: int,
                            pad: int = 0):
    """Differentiable framed_conv1d (bias only): the kernel forward on CUDA,
    the plain version on the CPU; the backward in torch ops."""
    return _FramedConv1d.apply(x, weight, bias, kernel_size, stride, pad)
