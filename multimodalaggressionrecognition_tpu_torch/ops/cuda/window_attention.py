"""Fused (shifted-)window attention: Swin3D's kernel (csrc/window_attention.cu)
and its plain PyTorch version.

The port of `fused_window_attention`'s forward (JAX package,
ops/pallas/window_attention.py): for packed qkv (W, N, 3C), a relative
position bias (heads, N, N) and an optional shifted-window mask
(nW_img, N, N), where window w uses mask[w % nW_img], it computes per window
and head `softmax(q k^T / sqrt(d) + bias[h] + mask) v` and returns (W, N, C).
The JAX layout and signature are kept.  Only the forward is ported: the
flash-style backward arrives with Swin fine-tuning.
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


def attention_core_reference(qkv, bias, mask, heads: int):
    """The plain version: (W, N, 3C), (heads, N, N), (nW_img, N, N) | None
    -> (W, N, C), with the score tensor materialized."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn = (q * d ** -0.5) @ k.transpose(-1, -2)  # (W, heads, N, N)
    attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(w // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(w, heads, n, n)
    out = torch.softmax(attn, dim=-1) @ v  # (W, heads, N, d)
    return out.transpose(1, 2).reshape(w, n, c)


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


def fused_window_attention(qkv, bias, mask, heads: int):
    """qkv (W, N, 3C) f32, bias (heads, N, N), mask (nW_img, N, N) or None
    -> (W, N, C).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if qkv.device.type == "cpu":
        return attention_core_reference(qkv, bias, mask, heads)
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
