"""tf32 rounding and the 3xTF32 split as the port's CUDA kernels compute
them (csrc/tf32x3.cuh), in numpy, for the CPU tests that emulate the
kernels' products (tests/test_torch_*_tf32x3.py)."""

import numpy as np

TF32_DROP = 0x1FFF  # the 13 low mantissa bits a tf32 lacks
TF32_KEEP = np.uint32(0xFFFFE000)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _float(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def tf32_rna(x):
    """cvt.rna.tf32.f32: to nearest, ties away from zero (finite x)."""
    return _float((_bits(x) + np.uint32(0x1000)) & TF32_KEEP)


def tf32_trunc(x):
    """What the mma makes of an f32 register: the low 13 bits dropped."""
    return _float(_bits(x) & TF32_KEEP)


def split_kernel(x):
    """tf32x3.cuh's split: Veltkamp's big (f32 ops), small truncated."""
    x = np.asarray(x, np.float32)
    c = x * np.float32(8193.0)
    big = c - (c - x)
    return big, tf32_trunc(x - big)


def split_rna(x):
    big = tf32_rna(x)
    return big, tf32_rna(np.asarray(x, np.float32) - big)


def split_one_pass(x):
    return tf32_rna(x), np.zeros_like(np.asarray(x, np.float32))
