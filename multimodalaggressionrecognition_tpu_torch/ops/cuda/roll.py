"""Circular roll of a (B, T, H, W, C) tensor over T, H and W: Swin3D's
shifted-window roll (csrc/roll.cu) and its plain PyTorch version.

The port of `pallas_roll` (benchmarks/proto_swin_levers.py, the JAX
package's Pallas prototype of the roll that its Swin3D makes with
`jnp.roll`): for shifts (st, sh, sw),

    out[b, t, h, w] = x[b, (t + st) mod T, (h + sh) mod H, (w + sw) mod W],

which is `torch.roll(x, (-st, -sh, -sw), (1, 2, 3))`.  The prototype rolls
H and W only; the kernel takes T too.  Each shift is reduced modulo its
size, so negative shifts roll the other way.  Both the wrapper and the
kernel take a contiguous float32 or bfloat16 tensor (the model's compute
dtypes; a copy is exact in either) of fewer than 2**31 elements and raise on
anything else; nothing is copied quietly.

`circular_roll` calls the `mar_torch::roll` op (torch.library): the plain
version on the CPU, the kernel on CUDA (the only place that counts a
launch), and a fake implementation for torch.export, which keeps the op in
a serving artifact's graph (io/export.py).

`roll` is the differentiable entry (a `torch.autograd.Function`): the
gradient of a roll is the roll of the gradient by the negated shifts, on a
CUDA tensor the same kernel again.  JAX differentiates `jnp.roll` the same
way; the prototype has no custom VJP.
"""

import ctypes

import torch

from ...utils.kernels import (check_status, launch_counts, launch_key,
                               load_library)

_P = ctypes.c_void_p
_I = ctypes.c_int


# dtype -> (the kernel's entry, elements per 16-byte vector)
_ENTRIES = {torch.float32: ("roll_f32", 4), torch.bfloat16: ("roll_16bit", 8)}


def _bind(lib):
    for entry, _ in _ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [_P, _P] + [_I] * 9 + [_P]
        fn.restype = _I


def roll_reference(x, shifts):
    """The plain version: torch.roll by the negated shifts over (T, H, W)."""
    st, sh, sw = shifts
    return torch.roll(x, (-st, -sh, -sw), (1, 2, 3))


def _validate(x, shifts):
    """Check what the kernel takes; returns the shifts reduced into
    [0, size)."""
    if x.dim() != 5:
        raise ValueError(f"roll: x must be (B, T, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"roll: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("roll: x must be contiguous")
    if not 0 < x.numel() < 2 ** 31:  # the kernel's indices are 32-bit ints
        raise ValueError(f"roll: {x.numel()} elements; the kernel takes "
                         "1 to 2**31 - 1")
    if len(shifts) != 3:
        raise ValueError(f"roll: shifts must be (st, sh, sw), got {shifts}")
    return tuple(int(s) % n for s, n in zip(shifts, x.shape[1:4]))


def circular_roll(x, shifts):
    """x (B, T, H, W, C) f32 or bf16, contiguous; shifts (st, sh, sw) -> out with
    out[b, t, h, w] = x[b, (t+st) % T, (h+sh) % H, (w+sw) % W]: the
    `mar_torch::roll` op.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    shifts = _validate(x, shifts)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roll: no kernel for device {x.device}")
    return torch.ops.mar_torch.roll(x, *shifts)


@torch.library.custom_op("mar_torch::roll", mutates_args=(),
                         device_types="cpu")
def _roll_op(x: torch.Tensor, st: int, sh: int, sw: int) -> torch.Tensor:
    return roll_reference(x, (st, sh, sw))


@_roll_op.register_fake
def _(x, st, sh, sw):
    return torch.empty_like(x)


@_roll_op.register_kernel("cuda")
def _roll_cuda(x, st, sh, sw):
    """The kernel launch: the only place that counts one."""
    shifts = _validate(x, (st, sh, sw))
    b, t, h, w, c = x.shape
    out = torch.empty_like(x)
    entry, per_vec = _ENTRIES[x.dtype]
    vec = (c % per_vec == 0 and x.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    lib = load_library("roll", _bind)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), b, t, h, w, c,
                                 *shifts, int(vec), stream)
    check_status("roll", status)
    launch_counts[launch_key("roll", x.dtype)] += 1
    return out


class _Roll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shifts):
        ctx.shifts = shifts
        return circular_roll(x, shifts)

    @staticmethod
    def backward(ctx, g):
        return circular_roll(g.contiguous(),
                             tuple(-s for s in ctx.shifts)), None


def roll(x, shifts):
    """Differentiable circular_roll: the kernel (or, for a CPU tensor, the
    plain version) forward, and the roll by the negated shifts backward."""
    return _Roll.apply(x, tuple(shifts))
