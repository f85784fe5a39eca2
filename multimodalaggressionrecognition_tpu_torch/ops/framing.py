"""Overlapping-frame extraction and frame x filter matmul (plain PyTorch).

A strided Conv1d over a waveform is exactly

    frames = frame_signal(x, kernel, stride)        # (B, T_out, K*C_in)
    y      = frames @ W + b

This is the plain version of the framed-conv kernel (ops/cuda/framed_conv.py):
it writes the (B, T, K*C_in) frame matrix to memory, which the kernel never
does.  Layout and weight convention follow the JAX package's ops/framing.py.
"""

import torch
import torch.nn.functional as F


def frame_signal(x: torch.Tensor, frame_len: int, hop: int, pad: int = 0):
    """Slice `x` (..., L) into overlapping frames: (..., T, frame_len).

    `pad` zero-pads both ends of the signal first (conv 'padding' semantics).
    T = (L + 2*pad - frame_len) // hop + 1.
    """
    if pad:
        x = F.pad(x, (pad, pad))
    return x.unfold(-1, frame_len, hop)


def framed_matmul(x: torch.Tensor, weight: torch.Tensor, bias, kernel_size: int,
                  stride: int, pad: int = 0):
    """Strided 1-D convolution with C_in channels as one matmul.

    x:      (B, L, C_in)   channels-last
    weight: (kernel_size * C_in, C_out), frame-major: torch's Conv1d weight
            (C_out, C_in, K) maps via w.permute(2, 1, 0).reshape(K*C_in, C_out)
    bias:   (C_out,) or None
    returns (B, T_out, C_out)
    """
    b, _, c_in = x.shape
    frames = frame_signal(x.transpose(1, 2), kernel_size, stride, pad)
    # (B, C_in, T, K) -> (B, T, K, C_in) -> (B, T, K*C_in)
    frames = frames.permute(0, 2, 3, 1).reshape(b, frames.shape[2],
                                                kernel_size * c_in)
    y = frames @ weight
    return y if bias is None else y + bias
