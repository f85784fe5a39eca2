"""Fused (shifted-)window attention: Swin3D's kernels, forward
(csrc/window_attention.cu) and backward (csrc/window_attention_bwd.cu), with
their plain PyTorch versions.

The port of `fused_window_attention` (JAX package,
ops/pallas/window_attention.py): for packed qkv (W, N, 3C), a relative
position bias (heads, N, N) and an optional shifted-window mask
(nW_img, N, N), where window w uses mask[w % nW_img], it computes per window
and head `softmax(q k^T / sqrt(d) + bias[h] + mask) v` and returns (W, N, C).
The JAX layout and signature are kept.  `window_attention` is the
differentiable entry (a `torch.autograd.Function`, the JAX `custom_vjp`):
its forward is `fused_window_attention`, its backward
`window_attention_bwd`, which returns the gradients of qkv and bias; the
mask gets none.
"""

import ctypes

import torch

from ...utils.kernels import check_status, launch_counts, load_library

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_TOKENS = 392             # a full (8, 7, 7) window
HEAD_DIMS = (8, 16, 32)      # the kernel's instantiations


def _bind(lib):
    lib.window_attention_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         ctypes.c_float, _P]
    lib.window_attention_f32.restype = _I


def _bind_bwd(lib):
    lib.window_attention_bwd_groups.argtypes = [_I, _I, _I, _I]
    lib.window_attention_bwd_groups.restype = _I
    lib.window_attention_bwd_f32.argtypes = [_P] * 9 + [_I] * 6 + [
        ctypes.c_float, _P]
    lib.window_attention_bwd_f32.restype = _I


def _split(qkv, heads: int):
    """(W, N, 3C) -> q, k, v as (W, heads, N, d)."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    return qkv.reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)


def _probs(q, k, bias, mask):
    """softmax(q k^T + bias + mask) over (W, heads, N, N); q pre-scaled."""
    w, heads, n, _ = q.shape
    attn = q @ k.transpose(-1, -2) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(w // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(w, heads, n, n)
    return torch.softmax(attn, dim=-1)


def attention_core_reference(qkv, bias, mask, heads: int):
    """The plain version: (W, N, 3C), (heads, N, N), (nW_img, N, N) | None
    -> (W, N, C), with the score tensor materialized."""
    w, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)
    # (W, heads, N, d)
    out = _probs(q * q.shape[-1] ** -0.5, k, bias, mask) @ v
    return out.transpose(1, 2).reshape(w, n, c3 // 3)


def window_attention_bwd_reference(qkv, bias, mask, g, heads: int):
    """The plain backward, the K3 formula in torch ops: recompute p, then
    dV = p^T g, dP = g v^T, dS = p (dP - rowsum(dP p)), dQ = dS k / sqrt(d),
    dK = dS^T q / sqrt(d) and dbias = sum over windows of dS.  Returns
    (dqkv (W, N, 3C), dbias (heads, N, N))."""
    w, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    gh = g.reshape(w, n, heads, d).transpose(1, 2)  # (W, heads, N, d)
    p = _probs(q * scale, k, bias, mask)
    dv = p.transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return dqkv, ds.sum(dim=0)


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"fused_window_attention: {name} must be float32, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"fused_window_attention: {name} on {t.device}, qkv "
                         f"on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_window_attention: {name} shape "
                         f"{tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_window_attention: {name} must be contiguous")


def _validate(qkv, bias, mask, heads: int):
    """Check what the kernels take; returns (W, N, C, d, nW_img)."""
    if qkv.device.type != "cuda":
        raise ValueError(
            f"fused_window_attention: no kernel for device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError("fused_window_attention: qkv must be (W, N, 3C), got "
                         f"{tuple(qkv.shape)}")
    w, n, c3 = qkv.shape
    c = c3 // 3
    if heads < 1 or c % heads:
        raise ValueError(f"fused_window_attention: C={c} is not a multiple of "
                         f"heads={heads}")
    d = c // heads
    _check("qkv", qkv, (w, n, c3), qkv.device)
    _check("bias", bias, (heads, n, n), qkv.device)
    nw = 0
    if mask is not None:
        nw = mask.shape[0] if mask.dim() == 3 else 0
        _check("mask", mask, (nw, n, n), qkv.device)
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
    if qkv.data_ptr() % 16:
        raise ValueError("fused_window_attention: qkv must be 16-byte aligned")
    return w, n, c, d, nw


def fused_window_attention(qkv, bias, mask, heads: int):
    """qkv (W, N, 3C) f32, bias (heads, N, N), mask (nW_img, N, N) or None
    -> (W, N, C).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type == "cpu":
        return attention_core_reference(qkv, bias, mask, heads)
    w, n, c, d, nw = _validate(qkv, bias, mask, heads)
    lib = load_library("window_attention", _bind)
    out = torch.empty((w, n, c), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    status = lib.window_attention_f32(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        w, n, heads, d, nw, d ** -0.5, stream)
    check_status("window_attention", status)
    launch_counts["window_attention"] += 1
    return out


def window_attention_bwd(qkv, bias, mask, g, heads: int):
    """The backward of `fused_window_attention` for output gradient g
    (W, N, C) f32: returns (dqkv (W, N, 3C), dbias (heads, N, N)).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, mask, g, heads)
    w, n, c, d, nw = _validate(qkv, bias, mask, heads)
    _check("g", g, (w, n, c), qkv.device)
    if g.data_ptr() % 16:
        raise ValueError("fused_window_attention: g must be 16-byte aligned")
    lib = load_library("window_attention_bwd", _bind_bwd)
    groups = lib.window_attention_bwd_groups(w, n, heads, d)
    if groups < 1:
        check_status("window_attention_bwd", -groups or 1)
    # the column pass reads the bias and mask transposed, so coalesced
    bias_t = bias.transpose(1, 2).contiguous()
    mask_t = None if mask is None else mask.transpose(1, 2).contiguous()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    partial = torch.empty((groups, heads, n, n), dtype=torch.float32,
                          device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    status = lib.window_attention_bwd_f32(
        qkv.data_ptr(), bias.data_ptr(), bias_t.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if mask_t is None else mask_t.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), partial.data_ptr(),
        w, n, heads, d, nw, groups, d ** -0.5, stream)
    check_status("window_attention_bwd", status)
    launch_counts["window_attention_bwd"] += 1
    return dqkv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, heads: int):
        ctx.heads = heads
        ctx.save_for_backward(qkv, bias, mask)
        return fused_window_attention(qkv, bias, mask, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, g.contiguous(),
                                           ctx.heads)
        return dqkv, dbias, None, None


def window_attention(qkv, bias, mask, heads: int):
    """Differentiable fused window attention: the forward kernel, and the
    backward kernel for the gradients of qkv and bias (the mask gets
    none)."""
    return _WindowAttention.apply(qkv, bias, mask, heads)
