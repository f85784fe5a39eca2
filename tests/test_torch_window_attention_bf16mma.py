"""The bf16 numerics of the window-attention kernels (K2, K3), on the CPU.

The bf16 instantiations of the CUDA kernels (csrc/window_attention.cu,
csrc/window_attention_bwd.cu) run every product on the bf16 tensor cores
(csrc/bf16mma.cuh) without widening their operands: a product of two bf16
operands (q.k^T, g.v^T) is exact products summed in f32, one mma.sync per
16-deep k-step (8-deep where d = 8); a product with an f32 operand x (the
probabilities p, and dS) splits x into hi = bf16(x) and lo = bf16(x - hi),
both rounded to nearest even as __float2bfloat16_rn does, and adds lo's
product and then hi's to the same f32 accumulator, per 16-deep k-step.
Here the plain forward and backward run with every product replaced by an
emulation of that, on inputs rounded to bf16 (qkv, the bias table and the
output gradient g, as the bf16 path gives them), and are held in f32,
before the output's rounding, against the JAX kernel in Pallas interpret
mode (as tests/test_pallas.py runs it off the TPU) on the same values
widened to f32: `fused_window_attention` at the shapes of
tests/test_torch_window_attention_tf32x3.py (forward, atol 1e-5) and its
vjp with the same g (gradients of qkv and the bias, atol 1e-4), each also
at Swin3D-T's window (4, 196, 3, 32, 2).  The backward's row pass is also
emulated as K3 bf16 runs it: p from the row logsumexp, D = rowsum(p dP)
summed in the sweep, and dQ = (A - D B) / sqrt(d) with A = (p dP) k and
B = p k, p dP and p in two bf16 pieces each.  A negative control shows that
one bf16 piece of p does not hold 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention)

FWD_SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0),
              (4, 196, 3, 32, 2)]
BWD_SHAPES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2),
              (4, 196, 3, 32, 2)]


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).float()


def mm_exact(a, b, depth):
    """a @ b for bf16-valued f32 tensors as one mma.sync a k-step computes
    it: the `depth`-deep k-step's products exact and summed (in float64,
    exact for 16 bf16 products), added to an f32 accumulator."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], depth):
        ks = slice(k0, k0 + depth)
        acc = (acc.double() + a[..., ks].double() @ b[..., ks, :].double()
               ).float()
    return acc


def mm_pieces(x, b, pieces=2):
    """x @ b for an f32 x and a bf16-valued b: x as hi and lo bf16 pieces
    (lo's product first), each 16-deep k-step of each piece added to an f32
    accumulator; pieces=1 takes hi alone (the negative control)."""
    hi = bf16(x)
    parts = (bf16(x - hi), hi) if pieces == 2 else (hi,)
    acc = torch.zeros(x.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, x.shape[-1], 16):
        ks = slice(k0, k0 + 16)
        for part in parts:
            acc = (acc.double()
                   + part[..., ks].double() @ b[..., ks, :].double()).float()
    return acc


def heads_of(qkv, heads):
    """(W, N, 3C) -> q, k, v as (W, heads, N, d)."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    return qkv.reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)


def scores(q, k, bias, mask):
    """q k^T / sqrt(d) + bias + mask in f32, q k^T exact per k-step."""
    w, heads, n, d = q.shape
    s = (mm_exact(q, k.transpose(-1, -2).contiguous(), min(d, 16))
         * d ** -0.5 + bias[None])
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(w // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(w, heads, n, n)
    return s


def forward(qkv, bias, mask, heads, pieces=2):
    """The forward with emulated products, in f32 before the output's
    rounding: (W, N, C).  As K2 does, the unnormalized exp(s - max) enters
    p.v and the row sum divides the result."""
    q, k, v = heads_of(qkv, heads)
    s = scores(q, k, bias, mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = mm_pieces(e, v.contiguous(), pieces) / e.sum(dim=-1, keepdim=True)
    w, n, c3 = qkv.shape
    return out.transpose(1, 2).reshape(w, n, c3 // 3)


def backward(qkv, bias, mask, g, heads):
    """The backward with emulated products, in f32: (dqkv, dbias)."""
    w, n, c3 = qkv.shape
    q, k, v = heads_of(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    gh = g.reshape(w, n, heads, d).transpose(1, 2).contiguous()
    p = torch.softmax(scores(q, k, bias, mask), dim=-1)
    dv = mm_pieces(p.transpose(-1, -2).contiguous(), gh)
    dp = mm_exact(gh, v.transpose(-1, -2).contiguous(), min(d, 16))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = mm_pieces(ds, k.contiguous()) * scale
    dk = mm_pieces(ds.transpose(-1, -2).contiguous(), q.contiguous()) * scale
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return dqkv, ds.sum(dim=0)


def backward_same_sweep(qkv, bias, mask, g, heads):
    """`backward` with dQ as K3 bf16's one row sweep computes it: p =
    exp(s - lse) from the rows' logsumexp, D = rowsum(p dP), and
    dQ = (A - D B) / sqrt(d), A = (p dP) k and B = p k each with the f32
    operand in two bf16 pieces; dK, dV and dbias as the column pass."""
    w, n, c3 = qkv.shape
    q, k, v = heads_of(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    gh = g.reshape(w, n, heads, d).transpose(1, 2).contiguous()
    s = scores(q, k, bias, mask)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dp = mm_exact(gh, v.transpose(-1, -2).contiguous(), min(d, 16))
    pdp = p * dp
    dsum = pdp.sum(dim=-1, keepdim=True)
    dq = (mm_pieces(pdp, k.contiguous())
          - dsum * mm_pieces(p, k.contiguous())) * scale
    ds = p * (dp - dsum)
    dv = mm_pieces(p.transpose(-1, -2).contiguous(), gh)
    dk = mm_pieces(ds.transpose(-1, -2).contiguous(), q.contiguous()) * scale
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return dqkv, ds.sum(dim=0)


def inputs(w, n, heads, d, nw, seed, bias_scale):
    """qkv, the bias, the mask and g, rounded to bf16 where the bf16 path
    has them in bf16 (the mask is f32: 0 or -100, exact)."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = bf16(torch.from_numpy(
        rng.standard_normal((w, n, 3 * c)).astype(np.float32)))
    bias = bf16(torch.from_numpy(
        (rng.standard_normal((heads, n, n)) * bias_scale).astype(np.float32)))
    mask = (torch.from_numpy(np.where(rng.uniform(0, 1, (nw, n, n)) > 0.7,
                                      -100.0, 0.0).astype(np.float32))
            if nw else None)
    g = bf16(torch.from_numpy(rng.standard_normal((w, n, c)).astype(
        np.float32)))
    return qkv, bias, mask, g


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.fixture(scope="module", params=FWD_SHAPES,
                ids=lambda c: "x".join(map(str, c)))
def fwd_case(request):
    w, n, heads, d, nw = request.param
    qkv, bias, mask, _ = inputs(w, n, heads, d, nw, seed=n, bias_scale=0.1)
    want = jax_fused_window_attention(_j(qkv), _j(bias), _j(mask), heads)
    return (qkv, bias, mask, heads), np.asarray(want)


@pytest.fixture(scope="module", params=BWD_SHAPES,
                ids=lambda c: "x".join(map(str, c)))
def bwd_case(request):
    """The JAX kernel's vjp at the bf16 output gradient g: the gradients of
    qkv and the bias."""
    w, n, heads, d, nw = request.param
    qkv, bias, mask, g = inputs(w, n, heads, d, nw, seed=n + nw,
                                bias_scale=1.0)
    jmask = _j(mask)
    _, vjp = jax.vjp(lambda a, b: jax_fused_window_attention(a, b, jmask,
                                                             heads),
                     _j(qkv), _j(bias))
    return (qkv, bias, mask, g, heads), [np.asarray(x) for x in vjp(_j(g))]


def test_pieces_round_to_nearest_even_and_leave_under_2_to_minus_16():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    x = torch.cat([x, x * 1e-20, x * 1e20])
    hi = bf16(x)
    lo = bf16(x - hi)
    # hi is x's nearest bf16, ties to even: the f32 bits rounded by hand
    bits = x.view(torch.int32).numpy().astype(np.int64)
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF
    np.testing.assert_array_equal(hi.view(torch.int32).numpy(),
                                  rne.astype(np.int32))
    # x - hi is exact in f32, and the two pieces leave < 2^-16 |x|
    left = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(left <= x.double().abs() * 2.0 ** -16)


def test_forward_in_bf16_pieces_matches_jax_kernel(fwd_case):
    (qkv, bias, mask, heads), want = fwd_case
    got = forward(qkv, bias, mask, heads)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_backward_in_bf16_pieces_matches_jax_vjp(bwd_case):
    (qkv, bias, mask, g, heads), want = bwd_case
    got = backward(qkv, bias, mask, g, heads)
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-4)


def test_backward_same_sweep_in_bf16_pieces_matches_jax_vjp(bwd_case):
    (qkv, bias, mask, g, heads), want = bwd_case
    got = backward_same_sweep(qkv, bias, mask, g, heads)
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("shape", [(6, 49, 3, 32, 3), (4, 196, 3, 32, 2)],
                         ids=lambda c: "x".join(map(str, c)))
def test_one_bf16_piece_of_p_misses_the_forward_tolerance(shape):
    """The negative control: p rounded to one bf16 piece is off the JAX
    kernel by more than 1e-5, where the two pieces hold it."""
    w, n, heads, d, nw = shape
    qkv, bias, mask, _ = inputs(w, n, heads, d, nw, seed=n, bias_scale=0.1)
    want = np.asarray(jax_fused_window_attention(_j(qkv), _j(bias), _j(mask),
                                                 heads))
    one = forward(qkv, bias, mask, heads, pieces=1)
    two = forward(qkv, bias, mask, heads)
    assert np.abs(one.numpy() - want).max() > 1e-5
    assert np.abs(two.numpy() - want).max() <= 1e-5
