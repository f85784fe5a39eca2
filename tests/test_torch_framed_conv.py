"""Port framed conv1d (ops/cuda/framed_conv.py) against the JAX kernel.

On the CPU the port's wrapper takes its plain version; the JAX side runs
`framed_conv1d_pallas` in interpret mode (as tests/test_pallas.py does) and
the grouped custom-VJP `framed_conv1d`.  Tolerance atol 1e-3, as in
tests/test_pallas.py; the autograd Function's gradients against the JAX
custom VJP at atol 2e-2, rtol 1e-4, as tests/test_pallas.py holds that VJP.
The CUDA kernel itself is held to the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops.pallas.framed_conv import (
    framed_conv1d as jax_framed_conv1d, framed_conv1d_pallas)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference, framed_conv1d_trainable)
from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
    launch_counts)

# (F, hop, pad, C_out): tests/test_pallas.py's shapes + a non-multiple F/hop
SHAPES = [(160, 40, 80, 64), (512, 256, 0, 128), (10, 5, 0, 512),
          (147, 40, 3, 24)]


def _inputs(seed, f, c, length=8000, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length)).astype(np.float32)
    w = (rng.standard_normal((f, c)) * 0.05).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


def _port(x, w, b, f, s, p, **kw):
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    with torch.inference_mode():
        return framed_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), f, s, p, **kw).numpy()


@pytest.mark.parametrize("f,s,p,c", SHAPES)
def test_plain_matches_jax_pallas_interpret(f, s, p, c):
    x, w, b = _inputs(f, f, c)
    want = framed_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                f, s, pad=p, interpret=True)
    got = _port(x, w, b, f, s, p)
    assert got.shape == want.shape == (2, (8000 + 2 * p - f) // s + 1, c)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("f,s,p,c", [(160, 40, 80, 64), (147, 40, 3, 24)])
def test_plain_matches_jax_grouped_custom_vjp(f, s, p, c):
    x, w, b = _inputs(7, f, c, length=4000)
    want = jax_framed_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             f, s, p)
    np.testing.assert_allclose(_port(x, w, b, f, s, p), np.asarray(want),
                               atol=1e-3)


@pytest.mark.parametrize("f,s,p,c", [(160, 40, 80, 64), (147, 40, 3, 24)])
def test_autograd_backward_matches_jax_custom_vjp(f, s, p, c):
    """dx, dW and dbias of sum(y ** 2), as tests/test_pallas.py checks the
    JAX custom VJP against XLA's gradients."""
    x, w, b = _inputs(11, f, c, length=4000)
    want = jax.grad(lambda *a: jnp.sum(jax_framed_conv1d(*a, f, s, p) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    torch.sum(framed_conv1d_trainable(*args, f, s, p) ** 2).backward()
    for got, ref in zip(args, want):
        assert got.grad.shape == ref.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=2e-2, rtol=1e-4)


def test_epilogue_matches_jax():
    x, w, b = _inputs(3, 160, 64, length=4000, batch=1)
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    shift = rng.normal(0.0, 0.3, 64).astype(np.float32)
    want = framed_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                160, 40, pad=80, scale=jnp.asarray(scale),
                                shift=jnp.asarray(shift), relu=True,
                                interpret=True)
    got = _port(x, w, b, 160, 40, 80, scale=scale, shift=shift, relu=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)
    assert (got >= 0).all()


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    x, w, b = _inputs(5, 160, 64, length=2000)
    before = launch_counts["framed_conv1d"]
    got = _port(x, w, b, 160, 40, 80)
    ref = framed_conv1d_reference(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), 160, 40, 80).numpy()
    np.testing.assert_array_equal(got, ref)
    assert launch_counts["framed_conv1d"] == before


def test_other_devices_raise():
    x = torch.zeros((2, 100), device="meta")
    w = torch.zeros((10, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        framed_conv1d(x, w, torch.zeros(4, device="meta"), 10, 5)

