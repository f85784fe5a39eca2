"""Fused (shifted-)window attention: Swin3D's kernels, forward
(csrc/window_attention.cu) and backward (csrc/window_attention_bwd.cu), with
their plain PyTorch versions.

The port of `fused_window_attention` (JAX package,
ops/pallas/window_attention.py): for packed qkv (W, N, 3C), a relative
position bias (heads, N, N) and an optional shifted-window mask
(nW_img, N, N), where window w uses mask[w % nW_img], it computes per window
and head `softmax(q k^T / sqrt(d) + bias[h] + mask) v` and returns (W, N, C).
The JAX layout and signature are kept.  `window_attention` is the
differentiable entry (a `torch.autograd.Function`, the JAX `custom_vjp`)
where a gradient is wanted: its forward is `window_attention_fwd`, which
also returns each row's logsumexp, its backward `window_attention_bwd`,
which reads that logsumexp instead of recomputing it and returns the
gradients of qkv and bias; the mask gets none.  Without a gradient it is
`fused_window_attention`, which writes no logsumexp.

`fused_window_attention` calls the `mar_torch::window_attention` op
(torch.library), `window_attention_fwd` the `mar_torch::window_attention_lse`
op: the plain version on the CPU, the forward kernel on CUDA (its launch
counted under one key for both, by `utils/kernels.launch`), and a fake
implementation for torch.export, which keeps the first op in a serving
artifact's graph (io/export.py).  The backward stays a plain wrapper:
export and quantization are for inference.

The row logsumexp lse (W, heads, N) is kept in base e for f32 (and the
plain versions' f64) and in base 2 for bf16, where the kernels keep their
scores in base 2 (`lse_in_base2`); it is f32 (f64 for f64 qkv).  The
backward's D = rowsum(p dP) comes by K3's route for the dtype: from the
forward's output, D = g . o, in f32, whose output is exact enough; in bf16,
whose output is rounded too coarsely for that, from p and dP in the one
sweep that also gives dQ = ((p dP) k - D p k) / sqrt(d).

Dtypes, as in the JAX kernels: qkv (and the output gradient g) are float32
or bfloat16, and the output and dqkv come back in qkv's dtype, with f32
accuracy inside and one rounding per stored result.  Each dtype has its
own kernel: float32 runs 3xTF32 products (csrc/tf32x3.cuh); bfloat16 runs
on the bf16 tensor cores without widening its operands, the products of
two bf16 operands exact and those with the f32 probabilities (and dS) in
two bf16 pieces (csrc/bf16mma.cuh).  The bias may be bfloat16 (a cast
model's bias table): like the JAX wrapper, this one hands the kernels its
f32 copy and returns dbias in the bias's dtype.  The mask is a constant,
always f32.  The plain versions compute in f32 for bf16 inputs.  (The JAX
package's CPU reference rounds the softmax probabilities to v's dtype
before P·V; its TPU kernel, and so this port, does not.)
"""

import math
from typing import Optional, Tuple

import torch

from ...utils.kernels import (check_tensor, launch, launch_key, load_library,
                               query)

MAX_TOKENS = 392             # a full (8, 7, 7) window
HEAD_DIMS = (8, 16, 32)      # the kernel's instantiations

_OP = "fused_window_attention"  # the kernels' name in their errors
# the storage dtypes of qkv, g, out and dqkv: the kernels' entry suffixes
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIGNATURES = {
    # qkv, bias, mask, out, lse, W, N, heads, d, nW_img, scale
    "window_attention": {"window_attention_f32": "PPPPPiiiiif",
                         "window_attention_bf16": "PPPPPiiiiif",
                         "window_attention_info": "iiio"},
    # qkv, bias, mask, g, (f32: out,) lse, dqkv, dbias, partial, W, N,
    # heads, d, nW_img, groups, scale; groups: W, N, heads, d, bf16
    "window_attention_bwd": {"window_attention_bwd_f32": "PPPPPPPPPiiiiiif",
                             "window_attention_bwd_bf16": "PPPPPPPPiiiiiif",
                             "window_attention_bwd_groups": "iiiii",
                             "window_attention_bwd_info": "iiio"}}


def launch_info(name: str, n: int, d: int, dtype=torch.float32) -> dict:
    """Kernel `name`'s ("window_attention" or "window_attention_bwd") launch
    at (N, d) on the current card, for its instantiation of qkv's `dtype`:
    threads per block, dynamic shared memory bytes and resident blocks per
    SM."""
    out = query(load_library(name, _SIGNATURES[name]), name + "_info", n, d,
                int(dtype == torch.bfloat16), n_out=3)
    return dict(zip(("threads", "dynamic_smem_bytes", "blocks_per_sm"), out))


def _split(qkv, heads: int):
    """(W, N, 3C) -> q, k, v as (W, heads, N, d)."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    return qkv.reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)


def _scores(q, k, bias, mask):
    """q k^T + bias + mask over (W, heads, N, N); q pre-scaled."""
    w, heads, n, _ = q.shape
    attn = q @ k.transpose(-1, -2) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(w // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(w, heads, n, n)
    return attn


LOG2E = 1.0 / math.log(2.0)


def lse_in_base2(dtype) -> bool:
    """Whether the row logsumexp for qkv of `dtype` is in base 2 (bf16, as
    its kernels keep their scores) rather than base e (f32, f64)."""
    return dtype == torch.bfloat16


def _wide(t):
    """bf16 widened to f32 (f32 and f64 stay as they are: the plain
    versions also run in float64 for the tests)."""
    return t.float() if t is not None and t.dtype == torch.bfloat16 else t


def attention_core_reference(qkv, bias, mask, heads: int,
                             with_lse: bool = False):
    """The plain version: (W, N, 3C), (heads, N, N), (nW_img, N, N) | None
    -> (W, N, C) in qkv's dtype, with the score tensor materialized; f32
    math for bf16 inputs.  `with_lse`: (out, lse), lse (W, heads, N) each
    row's logsumexp of its scores, in `lse_in_base2`'s base."""
    w, n, c3 = qkv.shape
    q, k, v = _split(_wide(qkv), heads)
    # (W, heads, N, d)
    s = _scores(q * q.shape[-1] ** -0.5, k, _wide(bias), _wide(mask))
    out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(
        w, n, c3 // 3).to(qkv.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, lse * LOG2E if lse_in_base2(qkv.dtype) else lse


def window_attention_bwd_reference(qkv, bias, mask, g, heads: int, lse,
                                   out=None, same_sweep=None):
    """The plain backward, the K3 formula in torch ops: p = exp(s - lse)
    from the forward's row logsumexp (`lse_in_base2`'s base for qkv's
    dtype), dV = p^T g, dP = g v^T, D = rowsum(dP p), dS = p (dP - D),
    dQ = dS k / sqrt(d), dK = dS^T q / sqrt(d) and dbias = sum over windows
    of dS, in f32 for bf16 inputs.  D comes by K3's route for the dtype:
    from the forward's output `out` (W, N, C), D = g . o, for f32 and f64;
    for bf16 (or with `same_sweep`) from p and dP, with
    dQ = ((p dP) k - D p k) / sqrt(d), where `out` is not read.
    Returns (dqkv (W, N, 3C) in qkv's dtype, dbias (heads, N, N) in the
    bias's)."""
    dtype, bias_dtype = qkv.dtype, bias.dtype
    if same_sweep is None:
        same_sweep = dtype == torch.bfloat16
    if not same_sweep and out is None:
        raise ValueError("window_attention_bwd: D from the forward's output "
                         "needs `out`")
    qkv, bias, mask, g = _wide(qkv), _wide(bias), _wide(mask), _wide(g)
    w, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    gh = g.reshape(w, n, heads, d).transpose(1, 2)  # (W, heads, N, d)
    s = _scores(q * scale, k, bias, mask)
    p = (torch.exp2(s * LOG2E - lse[..., None]) if lse_in_base2(dtype)
         else torch.exp(s - lse[..., None]))
    dv = p.transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    if same_sweep:
        pdp = p * dp
        dsum = pdp.sum(dim=-1, keepdim=True)
        dq = (pdp @ k - dsum * (p @ k)) * scale
    else:
        oh = _wide(out).reshape(w, n, heads, d).transpose(1, 2)
        dsum = (gh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - dsum)
    if not same_sweep:
        dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return dqkv.to(dtype), ds.sum(dim=0).to(bias_dtype)


def _validate(qkv, bias, mask, heads: int):
    """Check what the kernels take; returns (W, N, C, d, nW_img).  `bias`
    is the f32 copy the kernels read."""
    if qkv.device.type != "cuda":
        raise ValueError(
            f"fused_window_attention: no kernel for device {qkv.device}")
    if qkv.dtype not in _SUFFIX:
        raise TypeError(f"fused_window_attention: qkv must be float32 or "
                        f"bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError("fused_window_attention: qkv must be (W, N, 3C), got "
                         f"{tuple(qkv.shape)}")
    w, n, c3 = qkv.shape
    c = c3 // 3
    if heads < 1 or c % heads:
        raise ValueError(f"fused_window_attention: C={c} is not a multiple of "
                         f"heads={heads}")
    d = c // heads
    check_tensor(_OP, "qkv", qkv, (w, n, c3), qkv.dtype, qkv.device,
                 aligned=True)
    check_tensor(_OP, "bias", bias, (heads, n, n), torch.float32, qkv.device)
    nw = 0
    if mask is not None:
        nw = mask.shape[0] if mask.dim() == 3 else 0
        check_tensor(_OP, "mask", mask, (nw, n, n), torch.float32, qkv.device)
        if nw < 1 or w % nw:
            raise ValueError(f"fused_window_attention: W={w} windows is not "
                             f"a multiple of the mask's nW_img={nw}")
    if d not in HEAD_DIMS or not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"fused_window_attention: the kernel takes head dim "
                         f"{HEAD_DIMS} and 1..{MAX_TOKENS} tokens, got d={d} "
                         f"N={n}")
    if not 0 < w * heads < 2 ** 31:
        raise ValueError(f"fused_window_attention: W*heads={w * heads} blocks "
                         "do not fit the kernel's grid")
    return w, n, c, d, nw


def _bias_f32(bias):
    """The f32 bias the kernels read (a bf16 bias of a cast model is
    widened, as the JAX wrapper does before its pallas_call)."""
    return bias.float().contiguous() if bias.dtype == torch.bfloat16 else bias


def fused_window_attention(qkv, bias, mask, heads: int):
    """qkv (W, N, 3C) f32 or bf16, bias (heads, N, N), mask (nW_img, N, N)
    or None -> (W, N, C) in qkv's dtype: the `mar_torch::window_attention`
    op.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_window_attention: no kernel for device {qkv.device}")
    return torch.ops.mar_torch.window_attention(qkv, bias, mask, heads)


@torch.library.custom_op("mar_torch::window_attention", mutates_args=(),
                         device_types="cpu")
def _window_attention_op(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         heads: int) -> torch.Tensor:
    return attention_core_reference(qkv, bias, mask, heads)


@_window_attention_op.register_fake
def _(qkv, bias, mask, heads):
    w, n, c3 = qkv.shape
    return qkv.new_empty((w, n, c3 // 3))


@_window_attention_op.register_kernel("cuda")
def _window_attention_cuda(qkv, bias, mask, heads):
    return _launch_fwd(qkv, bias, mask, heads, with_lse=False)[0]


def _launch_fwd(qkv, bias, mask, heads: int, with_lse: bool):
    """The kernel launch, with or without the row logsumexp.  Returns (out,
    lse or None)."""
    bias = _bias_f32(bias)
    w, n, c, d, nw = _validate(qkv, bias, mask, heads)
    out = torch.empty((w, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((w, heads, n), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    launch(load_library("window_attention", _SIGNATURES["window_attention"]),
           f"window_attention_{_SUFFIX[qkv.dtype]}",
           launch_key("window_attention", qkv.dtype), qkv.device, qkv, bias,
           mask, out, lse, w, n, heads, d, nw, d ** -0.5)
    return out, lse


def window_attention_fwd(qkv, bias, mask, heads: int):
    """`fused_window_attention` that also returns each row's logsumexp for
    the backward: (out (W, N, C) in qkv's dtype, lse (W, heads, N) f32 in
    `lse_in_base2`'s base), the `mar_torch::window_attention_lse` op.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_window_attention: no kernel for device {qkv.device}")
    return torch.ops.mar_torch.window_attention_lse(qkv, bias, mask, heads)


@torch.library.custom_op("mar_torch::window_attention_lse", mutates_args=(),
                         device_types="cpu")
def _window_attention_lse_op(qkv: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return attention_core_reference(qkv, bias, mask, heads, with_lse=True)


@_window_attention_lse_op.register_fake
def _(qkv, bias, mask, heads):
    w, n, c3 = qkv.shape
    return (qkv.new_empty((w, n, c3 // 3)),
            qkv.new_empty((w, heads, n), dtype=torch.float32))


@_window_attention_lse_op.register_kernel("cuda")
def _window_attention_lse_cuda(qkv, bias, mask, heads):
    return _launch_fwd(qkv, bias, mask, heads, with_lse=True)


def window_attention_bwd(qkv, bias, mask, g, heads: int, lse, out=None):
    """The backward of `fused_window_attention` for output gradient g
    (W, N, C) in qkv's dtype, given the forward's row logsumexp `lse` and,
    for f32 qkv, its output `out` (both as `window_attention_fwd` returns
    them; a bf16 backward does not read `out`): returns (dqkv (W, N, 3C) in
    qkv's dtype, dbias (heads, N, N) in the bias's).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, mask, g, heads, lse,
                                              out)
    bias_dtype, bias = bias.dtype, _bias_f32(bias)
    w, n, c, d, nw = _validate(qkv, bias, mask, heads)
    check_tensor(_OP, "g", g, (w, n, c), qkv.dtype, qkv.device, aligned=True)
    check_tensor(_OP, "lse", lse, (w, heads, n), torch.float32, qkv.device)
    f32 = qkv.dtype == torch.float32
    if f32:
        if out is None:
            raise ValueError("window_attention_bwd: the f32 backward takes "
                             "the forward's output")
        check_tensor(_OP, "out", out, (w, n, c), torch.float32, qkv.device)
    lib = load_library("window_attention_bwd",
                       _SIGNATURES["window_attention_bwd"])
    groups = query(lib, "window_attention_bwd_groups", w, n, heads, d,
                   int(not f32))
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    partial = torch.empty((groups, heads, n, n), dtype=torch.float32,
                          device=qkv.device)
    launch(lib, f"window_attention_bwd_{_SUFFIX[qkv.dtype]}",
           launch_key("window_attention_bwd", qkv.dtype), qkv.device, qkv,
           bias, mask, g, *((out,) if f32 else ()), lse, dqkv, dbias, partial,
           w, n, heads, d, nw, groups, d ** -0.5)
    return dqkv, dbias.to(bias_dtype)


class _WindowAttention(torch.autograd.Function):
    """K2 with the row logsumexp, and K3 reading it.  Saves qkv, the bias,
    the mask, lse and, for f32 (whose backward takes D = g . o from it),
    the output: the tensor the next layer (the projection) keeps anyway."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads: int):
        out, lse = window_attention_fwd(qkv, bias, mask, heads)
        ctx.heads = heads
        ctx.save_for_backward(qkv, bias, mask, lse,
                              None if qkv.dtype == torch.bfloat16 else out)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask, lse, out = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, g.contiguous(),
                                           ctx.heads, lse, out)
        return dqkv, dbias, None, None


def window_attention(qkv, bias, mask, heads: int):
    """Differentiable fused window attention: where a gradient of qkv or the
    bias is wanted, the forward kernel with the row logsumexp and the
    backward kernel for the gradients of qkv and bias (the mask gets none);
    elsewhere `fused_window_attention` alone."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttention.apply(qkv, bias, mask, heads)
    return fused_window_attention(qkv, bias, mask, heads)
