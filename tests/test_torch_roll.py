"""K4, the circular roll of Swin3D's shifted windows (ops/cuda/roll.py),
against the JAX package's `pallas_roll` (benchmarks/proto_swin_levers.py,
run in interpret mode on the CPU) and `jnp.roll`.

A roll only moves values, so everything here is held bit for bit: the
plain version (`roll_reference`), the wrapper (`circular_roll`) and the
autograd Function (`roll`) on the CPU, forward and backward (the backward
against `jax.vjp` of `jnp.roll`).  The Function also runs inside the
port's remat (`models/stochastic.checkpoint`) and under `torch.no_grad`,
as the fine-tuned and the frozen Swin towers call it.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.models import swin3d as ts
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    checkpoint)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.roll import (
    circular_roll, roll, roll_reference)

_BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


@pytest.fixture(scope="module")
def pallas_roll():
    """The prototype's `pallas_roll`, imported with benchmarks/ prepended to
    sys.path for the import alone.  The prototype prepends the repo root
    itself and pulls in `bench_all`: the path is restored afterwards and
    the modules the import added under benchmark names are dropped, so
    they shadow nothing in later tests of the same worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(_BENCHMARKS)
        added = {"proto_swin_levers", "bench_all"} - set(sys.modules)
        fn = importlib.import_module("proto_swin_levers").pallas_roll
    for name in added:
        sys.modules.pop(name, None)
    return fn


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (shape, sh, sw): a small case, Swin3D-T's stage grids at a
# narrow C, the scalar path's C (3, 5) with odd H and W, and shift 0 on one
# axis
PALLAS_CASES = [((2, 4, 14, 14, 8), 3, 3), ((1, 4, 28, 28, 4), 3, 3),
                ((2, 4, 7, 9, 3), 3, 4), ((1, 2, 5, 7, 5), 0, 2),
                ((3, 1, 6, 4, 8), 5, 0)]


@pytest.mark.parametrize("shape,sh,sw", PALLAS_CASES)
def test_roll_equals_pallas_roll_bit_for_bit(pallas_roll, shape, sh, sw):
    x = _x(shape, seed=sh * 10 + sw)
    want = np.asarray(pallas_roll(jnp.asarray(x), sh, sw))
    np.testing.assert_array_equal(want, np.roll(x, (-sh, -sw), (2, 3)))
    xt = torch.from_numpy(x)
    for got in (roll_reference(xt, (0, sh, sw)), circular_roll(xt, (0, sh, sw)),
                roll(xt, (0, sh, sw))):
        np.testing.assert_array_equal(got.numpy(), want)


# (shape, shifts): a T shift, negative shifts, shifts past the size, all 0
JNP_CASES = [((2, 4, 6, 6, 8), (1, 3, 3)), ((1, 5, 7, 3, 3), (-2, 4, -1)),
             ((2, 3, 4, 5, 4), (7, -9, 11)), ((1, 2, 3, 3, 1), (0, 0, 0)),
             ((1, 8, 8, 8, 12), (4, 2, 2))]


@pytest.mark.parametrize("shape,shifts", JNP_CASES)
def test_roll_with_a_t_shift_equals_jnp_roll(shape, shifts):
    x = _x(shape, seed=len(shape) + sum(shifts))
    st, sh, sw = shifts
    want = np.asarray(jnp.roll(jnp.asarray(x), (-st, -sh, -sw), (1, 2, 3)))
    xt = torch.from_numpy(x)
    for got in (roll_reference(xt, shifts), circular_roll(xt, shifts),
                roll(xt, shifts)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,shifts", JNP_CASES[:3])
def test_backward_equals_jax_vjp_of_jnp_roll(shape, shifts):
    x, g = _x(shape, seed=1), _x(shape, seed=2)
    st, sh, sw = shifts
    _, vjp = jax.vjp(lambda v: jnp.roll(v, (-st, -sh, -sw), (1, 2, 3)),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    roll(xt, shifts).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_a_strided_gradient_is_rolled_back():
    """The backward takes whatever layout autograd hands it."""
    x = torch.from_numpy(_x((1, 2, 4, 6, 4))).requires_grad_(True)
    g = torch.from_numpy(_x((1, 2, 6, 4, 4), seed=3)).transpose(2, 3)
    roll(x, (1, 1, 2)).backward(g)
    assert torch.equal(x.grad, torch.roll(g, (1, 1, 2), (1, 2, 3)))


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.transpose(2, 3), "contiguous"),
    (lambda x: x.double(), "float32"),
    (lambda x: x[0], r"\(B, T, H, W, C\)"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, err):
    x = torch.from_numpy(_x((2, 2, 4, 4, 4)))
    with pytest.raises((ValueError, TypeError), match=err):
        circular_roll(bad(x), (0, 1, 1))
    with pytest.raises((ValueError, TypeError), match=err):
        roll(bad(x), (0, 1, 1))
    with pytest.raises(ValueError, match="shifts"):
        circular_roll(x, (1, 1))


def _shifted_block(seed=0):
    torch.manual_seed(seed)
    m = ts.ShiftedWindowAttention3d(8, 2, (2, 2, 2), (1, 1, 1))
    with torch.no_grad():
        m.relative_position_bias_table.normal_()
    return m


def test_roll_inside_remat_and_no_grad_matches_the_plain_pass():
    """The shifted block rolls twice a forward: through checkpoint's
    recompute the input gradient is the plain pass's, and under no_grad
    (the frozen tower) the output is."""
    m = _shifted_block()
    x = torch.from_numpy(_x((2, 4, 6, 6, 8), seed=4))
    x1 = x.clone().requires_grad_(True)
    m(x1).square().sum().backward()
    x2 = x.clone().requires_grad_(True)
    checkpoint(m, x2).square().sum().backward()
    assert torch.equal(x1.grad, x2.grad)
    with torch.no_grad():
        assert torch.equal(m(x), m(x1).detach())
