"""The 3xTF32 numerics of the framed-conv kernel (K1), on the CPU.

The CUDA kernel (csrc/framed_conv.cu) computes y = frames(x) @ W + bias as
an implicit GEMM on the tensor cores in 3xTF32 (csrc/tf32x3.cuh): every
frame value and weight is split into big (rounded to tf32 by Veltkamp's
split) and small (the rest, truncated to tf32 by the mma), and each 8-deep
k-step (8 taps, in the kernel's chunk order, zero past F) adds big*small,
then small*big, then big*big to an f32 accumulator, one rounding each, as
one mma.sync.m16n8k8 does.  Here that product is emulated in numpy and held
against the JAX kernel (`framed_conv1d_pallas` in Pallas interpret mode, as
tests/test_pallas.py runs it off the TPU) at K1's three routes and a
non-multiple F/hop, at small B and L, with tests/test_pallas.py's
tolerances:

  stem      F=160, hop 40, pad 80, C=64            atol 1e-3
  stft      ops/stft.py's DFT basis, F=512, hop 256,
            C=514, reflect-padded signal            atol 1e-2, rtol 1e-4
  resample  ops/resample.py's 44.1 -> 16 kHz bank,
            F=475, hop 441, C=160                   atol 1e-4
  f147      F=147, hop 40, pad 3, C=24              atol 1e-3

and against the port's plain version at 1e-4, as chip_smoke.py holds the
kernel to it on the card.  A negative control shows that one TF32 pass
misses 1e-5 at the stem, which the 3xTF32 emulation meets with 10x to
spare (it lands within ~8e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32x3 import split_kernel, split_one_pass
from multimodalaggressionrecognition_tpu.ops.pallas.framed_conv import (
    framed_conv1d_pallas)
from multimodalaggressionrecognition_tpu.ops.resample import resample_kernel
from multimodalaggressionrecognition_tpu.ops.stft import _dft_bases_np
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d_reference)

# (atol, rtol) against the JAX kernel
TOLERANCES = {"stem": (1e-3, 0.0), "stft": (1e-2, 1e-4),
              "resample": (1e-4, 0.0), "f147": (1e-3, 0.0)}
CONTROL_TOL = 1e-5


def route(name):
    """(x, w, bias, F, hop, pad) of one K1 route at small B and L."""
    rng = np.random.default_rng(list(TOLERANCES).index(name))
    if name == "stft":  # spectrogram(): reflect-padded, [real | imag] basis
        x = np.pad(rng.standard_normal((2, 8000)).astype(np.float32),
                   ((0, 0), (256, 256)), mode="reflect")
        w = np.concatenate(_dft_bases_np(512), axis=1)
        return x, w, np.zeros(514, np.float32), 512, 256, 0
    if name == "resample":  # resample_poly(x, 44100, 16000)
        kernels, width, orig_g, new_g = resample_kernel(44100, 16000)
        x = np.pad(rng.standard_normal((2, 4000)).astype(np.float32),
                   ((0, 0), (width, width + orig_g)))
        return (x, np.ascontiguousarray(kernels.T),
                np.zeros(new_g, np.float32), kernels.shape[1], orig_g, 0)
    f, hop, pad, c = {"stem": (160, 40, 80, 64),
                      "f147": (147, 40, 3, 24)}[name]
    x = rng.standard_normal((2, 8000)).astype(np.float32)
    w = (rng.standard_normal((f, c)) * 0.05).astype(np.float32)
    return x, w, rng.standard_normal(c).astype(np.float32), f, hop, pad


def frames_of(x, f, hop, pad):
    """(B * T, F) frames of the zero-padded signal."""
    xp = np.pad(x, ((0, 0), (pad, pad)))
    t = (xp.shape[1] - f) // hop + 1
    idx = np.arange(t)[:, None] * hop + np.arange(f)[None, :]
    return xp[:, idx].reshape(-1, f), t


def k1_emulated(x, w, bias, f, hop, pad, split):
    """framed_conv1d(x, w, bias) as the kernel computes it: (B, T, C)."""
    a, t = frames_of(x, f, hop, pad)
    k = -(-f // 8) * 8  # taps in whole k-steps, zero past F
    a = np.pad(a, ((0, 0), (0, k - f)))
    wk = np.pad(w, ((0, k - f), (0, 0)))
    (a_big, a_small), (w_big, w_small) = split(a), split(wk)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, k, 8):
        ks = slice(k0, k0 + 8)
        for p, q in ((a_big, w_small), (a_small, w_big), (a_big, w_big)):
            # a tf32 x tf32 product is exact; one f32 rounding per k-step
            term = p[:, ks].astype(np.float64) @ q[ks].astype(np.float64)
            acc = (acc.astype(np.float64) + term).astype(np.float32)
    return (acc + bias).reshape(x.shape[0], t, w.shape[1])


@pytest.fixture(scope="module", params=list(TOLERANCES))
def case(request):
    """A route's inputs and the JAX kernel's output (interpret mode)."""
    x, w, bias, f, hop, pad = route(request.param)
    want = framed_conv1d_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias), f, hop, pad=pad,
                                interpret=True)
    return request.param, (x, w, bias, f, hop, pad), np.asarray(want)


def test_3xtf32_matches_jax_kernel(case):
    name, args, want = case
    got = k1_emulated(*args, split_kernel)
    assert got.shape == want.shape
    atol, rtol = TOLERANCES[name]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_3xtf32_matches_plain_version(case):
    """The port's plain version lies within the 1e-4 to which the card holds
    the kernel (chip_smoke.py, tests/test_torch_cuda.py)."""
    _, (x, w, bias, f, hop, pad), _ = case
    plain = framed_conv1d_reference(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(bias), f, hop, pad)
    np.testing.assert_allclose(k1_emulated(x, w, bias, f, hop, pad,
                                           split_kernel),
                               plain.numpy(), atol=1e-4, rtol=1e-4)


def test_one_tf32_pass_misses_what_3xtf32_meets():
    """The negative control at the stem: one TF32 pass (big only) is off by
    more than CONTROL_TOL; the 3xTF32 emulation stays 10x inside it."""
    x, w, bias, f, hop, pad = route("stem")
    want = np.asarray(framed_conv1d_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), f, hop, pad=pad,
        interpret=True))
    one = np.abs(k1_emulated(x, w, bias, f, hop, pad, split_one_pass) - want)
    three = np.abs(k1_emulated(x, w, bias, f, hop, pad, split_kernel) - want)
    assert one.max() > CONTROL_TOL
    assert three.max() * 10 <= CONTROL_TOL
