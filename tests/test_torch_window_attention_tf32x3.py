"""The 3xTF32 numerics of the window-attention kernels (K2, K3), on the CPU.

The CUDA kernels (csrc/window_attention.cu, csrc/window_attention_bwd.cu)
do every product on the tensor cores in 3xTF32 (csrc/tf32x3.cuh): each f32
operand x is split into big (x in tf32) and small (x - big), and a*b is
big*small + small*big + big*big, each tf32 x tf32 product exact, summed in
f32.  Here the plain forward and backward run with every product replaced
by an emulation of that, for two splits:

  kernel - the kernels' own: big = x rounded to 11 significant bits by
           Veltkamp's split, small = x - big, truncated to tf32 by the mma;
  rna    - cvt.rna.tf32.f32 for both halves (to nearest, ties away from
           zero).

Both are held against the JAX kernel (`fused_window_attention`, and
`jax.grad` through it, in Pallas interpret mode as tests/test_pallas.py
runs it off the TPU) at the shapes of tests/test_torch_window_attention.py
(forward, atol 1e-5) and tests/test_torch_window_attention_bwd.py
(gradients, atol 1e-4).  A negative control shows that one TF32 pass does
not hold 1e-5.  The emulation adds each 8-deep k-step of each term to an
f32 accumulator, as one mma.sync.m16n8k8 does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32x3 import (TF32_DROP, _bits, split_kernel, split_one_pass,
                     split_rna, tf32_rna)
from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention)

FWD_SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0),
              (4, 196, 3, 32, 2)]
BWD_SHAPES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2)]
SPLITS = {"kernel": split_kernel, "rna": split_rna}


def mm3(a, b, split):
    """a @ b (float32 tensors, batched) as the kernels compute it."""
    ab, asm = (torch.from_numpy(t) for t in split(a.numpy()))
    bb, bsm = (torch.from_numpy(t) for t in split(b.numpy()))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((ab, bsm), (asm, bb), (ab, bb)):  # small terms first
            term = x[..., ks].double() @ y[..., ks, :].double()  # exact
            acc = (acc.double() + term).float()
    return acc


def heads_of(qkv, heads):
    """(W, N, 3C) -> q, k, v as (W, heads, N, d)."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    return qkv.reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)


def probs(qs, k, bias, mask, split):
    w, heads, n, _ = qs.shape
    s = mm3(qs, k.transpose(-1, -2).contiguous(), split) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(w // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(w, heads, n, n)
    return torch.softmax(s, dim=-1)


def forward(qkv, bias, mask, heads, split):
    """The plain forward with emulated products: (W, N, C)."""
    q, k, v = heads_of(qkv, heads)
    qs = q * q.shape[-1] ** -0.5  # pre-scaled before splitting, as K2 does
    out = mm3(probs(qs, k, bias, mask, split), v.contiguous(), split)
    w, n, c3 = qkv.shape
    return out.transpose(1, 2).reshape(w, n, c3 // 3)


def backward(qkv, bias, mask, g, heads, split):
    """The plain backward with emulated products: (dqkv, dbias)."""
    w, n, c3 = qkv.shape
    q, k, v = heads_of(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    qs = q * scale
    gh = g.reshape(w, n, heads, d).transpose(1, 2).contiguous()
    p = probs(qs, k, bias, mask, split)
    dv = mm3(p.transpose(-1, -2).contiguous(), gh, split)
    dp = mm3(gh, v.transpose(-1, -2).contiguous(), split)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = mm3(ds, k.contiguous(), split) * scale
    dk = mm3(ds.transpose(-1, -2).contiguous(), qs.contiguous(), split)
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return dqkv, ds.sum(dim=0)


def inputs(w, n, heads, d, nw, seed, bias_scale):
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((w, n, 3 * c)).astype(np.float32)
    bias = (rng.standard_normal((heads, n, n)) * bias_scale).astype(
        np.float32)
    mask = (np.where(rng.uniform(0, 1, (nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if nw else None)
    return qkv, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module", params=FWD_SHAPES,
                ids=lambda c: "x".join(map(str, c)))
def fwd_case(request):
    """Inputs (as tests/test_torch_window_attention.py draws them) and the
    JAX kernel's output."""
    w, n, heads, d, nw = request.param
    qkv, bias, mask = inputs(w, n, heads, d, nw, seed=n, bias_scale=0.1)
    want = jax_fused_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), heads)
    return (qkv, bias, mask, heads), np.asarray(want)


@pytest.fixture(scope="module", params=BWD_SHAPES,
                ids=lambda c: "x".join(map(str, c)))
def bwd_case(request):
    """Inputs (as tests/test_torch_window_attention_bwd.py draws them) and
    JAX's gradients of sum(out ** 2) w.r.t. qkv and bias."""
    w, n, heads, d, nw = request.param
    qkv, bias, mask = inputs(w, n, heads, d, nw, seed=n + nw, bias_scale=1.0)
    jmask = None if mask is None else jnp.asarray(mask)
    grads = jax.grad(lambda a, b: jnp.sum(
        jax_fused_window_attention(a, b, jmask, heads) ** 2),
        argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    return (qkv, bias, mask, heads), [np.asarray(x) for x in grads]


def test_kernel_split_rounds_to_nearest_tf32():
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    x = np.concatenate([x, x * np.float32(1e-30), x * np.float32(1e30)])
    big, small = split_kernel(x)
    assert not np.any(_bits(big) & TF32_DROP)  # a tf32
    np.testing.assert_array_equal(big + (x - big), x)  # small is exact
    # big is x's nearest tf32: it differs from rna only at exact ties
    rna = tf32_rna(x)
    ties = (_bits(x) & TF32_DROP) == 0x1000
    np.testing.assert_array_equal(big[~ties], rna[~ties])
    # the truncated small leaves less than 2^-21 |x|
    left = np.abs(x.astype(np.float64) - big - small)
    assert np.all(left <= np.abs(x.astype(np.float64)) * 2.0 ** -21)


@pytest.mark.parametrize("split", SPLITS)
def test_forward_in_3xtf32_matches_jax_kernel(fwd_case, split):
    (qkv, bias, mask, heads), want = fwd_case
    got = forward(_t(qkv), _t(bias), _t(mask), heads, SPLITS[split])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("split", SPLITS)
def test_backward_in_3xtf32_matches_jax_grad(bwd_case, split):
    (qkv, bias, mask, heads), want = bwd_case
    args = _t(qkv), _t(bias), _t(mask)
    g = 2 * forward(*args, heads, SPLITS[split])
    got = backward(*args, g, heads, SPLITS[split])
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-4)


def test_one_tf32_pass_misses_the_forward_tolerance():
    """The negative control: plain TF32 (big only) at (W=6, N=49, heads=3,
    d=32, nW=3), the inputs of the forward case above, is off by more than
    1e-5."""
    w, n, heads, d, nw = 6, 49, 3, 32, 3
    qkv, bias, mask = inputs(w, n, heads, d, nw, seed=n, bias_scale=0.1)
    want = np.asarray(jax_fused_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), heads))
    one = forward(_t(qkv), _t(bias), _t(mask), heads, split_one_pass)
    three = forward(_t(qkv), _t(bias), _t(mask), heads, split_kernel)
    assert np.abs(one.numpy() - want).max() > 1e-5
    assert np.abs(three.numpy() - want).max() <= 1e-5
