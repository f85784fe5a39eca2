"""Port window-attention backward (K3's plain version and the autograd
Function of ops/cuda/window_attention.py) against JAX's.

The JAX side is `jax.grad` of `fused_window_attention`, whose custom VJP
runs the Pallas backward in interpret mode off the TPU, as
tests/test_pallas.py runs it.  Shapes: that test's gradient case
(W=6, N=24, 3 heads, d=8), without and with a shifted-window mask, plus a
clamped N=64 window (Swin3D-T's last stage) with d=16.  Tolerance atol 1e-4
for dqkv and dbias, as tests/test_pallas.py holds the JAX kernel's grads.
The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, window_attention, window_attention_bwd,
    window_attention_bwd_reference)
from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
    launch_counts)

# (W, N, heads, d, nW_img); nW_img 0 = no mask
CASES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2)]


def inputs(w, n, heads, d, nw, seed):
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((w, n, 3 * c)).astype(np.float32)
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = (np.where(rng.uniform(0, 1, (nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if nw else None)
    return qkv, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "x".join(map(str, c)))
def case(request):
    """The inputs and JAX's gradients of sum(out ** 2) w.r.t. qkv, bias."""
    w, n, heads, d, nw = request.param
    qkv, bias, mask = inputs(w, n, heads, d, nw, seed=n + nw)
    jmask = None if mask is None else jnp.asarray(mask)
    grads = jax.grad(lambda a, b: jnp.sum(
        jax_fused_window_attention(a, b, jmask, heads) ** 2),
        argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    return (qkv, bias, mask, heads), [np.asarray(g) for g in grads]


def test_autograd_function_matches_jax_grad(case):
    (qkv, bias, mask, heads), want = case
    q = _t(qkv).requires_grad_()
    b = _t(bias).requires_grad_()
    m = _t(mask)
    torch.sum(window_attention(q, b, m, heads) ** 2).backward()
    for got, ref in zip((q.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    if m is not None:
        assert m.grad is None


def test_plain_backward_matches_jax_grad(case):
    (qkv, bias, mask, heads), want = case
    out, lse = attention_core_reference(_t(qkv), _t(bias), _t(mask), heads,
                                        with_lse=True)
    got = window_attention_bwd_reference(_t(qkv), _t(bias), _t(mask),
                                         2 * out, heads, lse, out)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4)


def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    (qkv, bias, mask, heads), _ = case
    q = _t(qkv).double().requires_grad_()
    b = _t(bias).double().requires_grad_()
    m = None if mask is None else _t(mask).double()
    out = attention_core_reference(q, b, m, heads)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape))
    want = torch.autograd.grad(out, (q, b), g)
    fwd, lse = attention_core_reference(q.detach(), b.detach(), m, heads,
                                        with_lse=True)
    got = window_attention_bwd_reference(q.detach(), b.detach(), m, g, heads,
                                         lse, fwd)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-10)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    qkv, bias, mask = inputs(4, 24, 3, 8, 2, seed=2)
    g = torch.ones((4, 24, 24))
    out, lse = attention_core_reference(_t(qkv), _t(bias), _t(mask), 3,
                                        with_lse=True)
    before = launch_counts["window_attention_bwd"]
    got = window_attention_bwd(_t(qkv), _t(bias), _t(mask), g, 3, lse, out)
    want = window_attention_bwd_reference(_t(qkv), _t(bias), _t(mask), g, 3,
                                          lse, out)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert launch_counts["window_attention_bwd"] == before


def test_other_devices_raise():
    qkv = torch.zeros((2, 4, 24), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        window_attention_bwd(qkv, torch.zeros((1, 4, 4), device="meta"),
                             None, torch.zeros((2, 4, 8), device="meta"), 1,
                             torch.zeros((2, 1, 4), device="meta"),
                             torch.zeros((2, 4, 8), device="meta"))
