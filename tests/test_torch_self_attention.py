"""The self-attention kernels' plain version and routing
(ops/cuda/self_attention.py) on the CPU.

The plain version, which a CPU tensor takes, is held bit for bit to
`MultiheadSelfAttention._attend`'s own composition without a mask, forward
and gradient of qkv, in f32 and bf16, on the uniforms the layer's dropout
draws (rate 0.1 and 0), at a ragged T next to a tile multiple and at head
dims 64 and 32.  The routing: masked, f32, CPU or an unsupported head dim
keep the composition; an unmasked CUDA bf16 qkv at d = 64 or 32 takes the
kernels, handed the dropout's one draw.  The formulas the backward kernels
compute (D from p and dP, dQ as (p dP) k - D p k, the mask applied to dP)
are held to autograd in float64.  The kernels themselves run only on a
card (tests/test_torch_cuda.py).
"""

import math
import types

import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.models import layers
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    MultiheadSelfAttention)
from multimodalaggressionrecognition_tpu_torch.ops.cuda import (
    self_attention as sa)

SEED = 7


def _layer(heads, d, rate):
    torch.manual_seed(0)
    m = MultiheadSelfAttention(heads * d, heads, rate).train()
    m.dropout.generator = torch.Generator().manual_seed(SEED)
    return m


def _qkv(b, t, heads, d, dtype):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(b, t, 3 * heads * d, generator=g) * 0.5).to(dtype)


def _uniforms(b, heads, t):
    """The dropout's draw: one torch.rand of the scores' shape from a
    generator seeded as the layer's."""
    return torch.rand((b, heads, t, t),
                      generator=torch.Generator().manual_seed(SEED))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("t", [37, 64])
@pytest.mark.parametrize("d", [64, 32])
def test_plain_version_is_the_layer_composition(dtype, rate, t, d):
    """Forward and gradient of qkv, bit for bit, on the same uniforms."""
    b, heads = 2, 2
    layer = _layer(heads, d, rate)
    base = _qkv(b, t, heads, d, dtype)
    x1 = base.clone().requires_grad_(True)
    x2 = base.clone().requires_grad_(True)
    want = layer._attend(x1, None, 0, 1)
    u = _uniforms(b, heads, t) if rate else None
    got = sa.self_attention(x2, u, heads, 1.0 - rate)
    assert got.dtype == dtype and got.shape == (b, t, heads * d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    (want.float() * cot).sum().backward()
    (got.float() * cot).sum().backward()
    torch.testing.assert_close(x2.grad, x1.grad, rtol=0, atol=0)
    drew = torch.Generator().manual_seed(SEED)
    if rate:  # the layer drew once, what `_uniforms` draws
        torch.rand((b, heads, t, t), generator=drew)
    assert torch.equal(layer.dropout.generator.get_state(), drew.get_state())


def test_plain_version_drops_where_u_is_not_below_keep():
    """A weight is kept (times 1/keep) exactly where u < keep: u = keep
    drops, the f32 value just under it keeps."""
    b, t, heads, d = 1, 5, 1, 32
    qkv = _qkv(b, t, heads, d, torch.float32)
    keep = 0.9
    k32 = torch.tensor(keep, dtype=torch.float32)
    u = torch.full((b, heads, t, t), 0.5)
    u[0, 0, 0, :] = k32
    u[0, 0, 1, :] = torch.nextafter(k32, torch.tensor(0.0))
    out = sa.self_attention_reference(qkv, u, heads, keep)
    assert torch.equal(out[0, 0], torch.zeros(d))
    full = sa.self_attention_reference(qkv, None, heads)
    torch.testing.assert_close(out[0, 1], full[0, 1] / keep)


KERNEL_ROUTES = [
    # (device, dtype, head dim, masked, takes the kernels)
    ("cuda", torch.bfloat16, 64, False, True),
    ("cuda", torch.bfloat16, 32, False, True),
    ("cuda", torch.bfloat16, 64, True, False),
    ("cuda", torch.float32, 64, False, False),
    ("cpu", torch.bfloat16, 64, False, False),
    ("cuda", torch.bfloat16, 16, False, False),
    ("cuda", torch.bfloat16, 128, False, False),
]


def _judged_on(device):
    """`kernel_takes` as it judges a qkv of the same dtype on `device`."""
    return lambda qkv, hd: sa.kernel_takes(types.SimpleNamespace(
        device=torch.device(device), dtype=qkv.dtype), hd)


@pytest.mark.parametrize("device,dtype,d,masked,kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_attend_routes_by_its_input(monkeypatch, device, dtype, d, masked,
                                    kernel, rate):
    """`_attend` takes the kernels exactly where `kernel_takes` holds for
    the qkv it sees (here a CPU tensor standing in for one on `device`)
    and there is no mask; they get the dropout's one draw (None in eval or
    at rate 0) and keep = 1 - rate, and the generator moves as the
    composition moves it."""
    b, t, heads = 2, 9, 2
    calls = []

    def spy(qkv, u, h, keep):
        calls.append((u, h, keep))
        return sa.self_attention_reference(qkv, u, h, keep)

    monkeypatch.setattr(layers, "self_attention", spy)
    mask = torch.zeros(b, t, dtype=torch.bool) if masked else None
    qkv = _qkv(b, t, heads, d, dtype)
    for training in (True, False):
        composed = _layer(heads, d, rate).train(training)
        monkeypatch.setattr(layers, "kernel_takes", lambda *a: False)
        want = composed._attend(qkv, mask, 0, 1)
        layer = _layer(heads, d, rate).train(training)
        monkeypatch.setattr(layers, "kernel_takes", _judged_on(device))
        out = layer._attend(qkv, mask, 0, 1)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        assert torch.equal(layer.dropout.generator.get_state(),
                           composed.dropout.generator.get_state())
        if not kernel:
            assert calls == []
            continue
        u, h, keep = calls.pop()
        assert (h, keep) == (heads, 1.0 - rate)
        if training and rate:
            assert torch.equal(u, _uniforms(b, heads, t))
        else:
            assert u is None


def test_kernel_takes_only_cuda_bf16_at_its_head_dims():
    for device, dtype, d, masked, kernel in KERNEL_ROUTES:
        if masked:
            continue
        qkv = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
        assert sa.kernel_takes(qkv, d) is kernel
    assert sa.HEAD_DIMS == (32, 64)


def test_kernel_entry_refuses_what_the_kernels_do_not_take():
    """The backward entry has no plain version: a CPU tensor raises."""
    qkv = torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA bf16"):
        sa.self_attention_bwd(qkv, torch.zeros(1, 4, 64, dtype=torch.bfloat16),
                              torch.zeros(1, 1, 4), None, 1)
    with pytest.raises(ValueError, match="3 heads d"):
        sa.self_attention_bwd(torch.zeros(1, 4, 10, dtype=torch.bfloat16),
                              None, None, None, 3)


def test_eval_op_is_the_plain_version_on_the_cpu():
    """`mar_torch::self_attention` (the no-gradient, no-dropout forward
    that torch.export keeps) runs the plain version on the CPU, and its
    fake gives the kernel's shape and dtype."""
    qkv = _qkv(2, 11, 2, 32, torch.bfloat16)
    got = torch.ops.mar_torch.self_attention(qkv, 2)
    torch.testing.assert_close(got, sa.self_attention_reference(qkv, None, 2),
                               rtol=0, atol=0)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = torch.ops.mar_torch.self_attention(mode.from_tensor(qkv), 2)
    assert fake.shape == (2, 11, 64) and fake.dtype == torch.bfloat16


def _kernel_formulas(q, k, v, g, u, keep, tile=64):
    """What the kernels compute, in float64 from the same inputs: the
    forward's online softmax over 64-key tiles in base 2 with the row
    logsumexp, the keep mask m = u < keep, and the backward's recomputed
    p = exp2(s log2e / sqrt(d) - lse), dP = (g v^T) m / keep,
    D = rowsum(p dP), dQ = ((p dP) k - D (p k)) / sqrt(d),
    dK = (p (dP - D))^T q / sqrt(d), dV = (p m / keep)^T g."""
    t, d = q.shape[-2:]
    scale2 = 1.0 / math.sqrt(d) / math.log(2.0)
    m = (u < keep).double() if u is not None else torch.ones(t, t).double()
    s = (q @ k.transpose(-1, -2)) * scale2
    run_max = torch.full(s.shape[:-1], -math.inf, dtype=s.dtype)
    run_sum = torch.zeros_like(run_max)
    o = torch.zeros(*s.shape[:-1], d, dtype=s.dtype)
    for j0 in range(0, t, tile):
        st = s[..., j0:j0 + tile]
        new = torch.maximum(run_max, st.amax(-1))
        corr = torch.exp2(run_max - new)
        p = torch.exp2(st - new[..., None])
        run_sum = run_sum * corr + p.sum(-1)
        o = o * corr[..., None] + (p * m[..., j0:j0 + tile]) @ v[..., j0:j0 + tile, :]
        run_max = new
    out = o / (run_sum[..., None] * keep)
    lse = run_max + torch.log2(run_sum)
    p = torch.exp2(s - lse[..., None])
    dp = (g @ v.transpose(-1, -2)) * m / keep
    dsum = (p * dp).sum(-1, keepdim=True)
    dq = ((p * dp) @ k - dsum * (p @ k)) / math.sqrt(d)
    ds = p * (dp - dsum)
    dk = ds.transpose(-1, -2) @ q / math.sqrt(d)
    dv = (p * m / keep).transpose(-1, -2) @ g
    return out, dq, dk, dv


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("t", [37, 130])
def test_kernel_formulas_match_autograd_in_float64(rate, t):
    """The kernels' online forward and backward formulas against autograd
    of softmax(q k^T / sqrt(d)) m / keep v in float64, on one head."""
    d = 32
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(2, t, d, generator=gen, dtype=torch.float64)
                  for _ in range(4))
    u = torch.rand(2, t, t, generator=gen) if rate else None
    keep = 1.0 - rate
    out, dq, dk, dv = _kernel_formulas(q, k, v, g, u, keep)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    p = torch.softmax(qq @ kk.transpose(-1, -2) / math.sqrt(d), dim=-1)
    if u is not None:
        p = torch.where(u < keep, p / keep, 0.0)
    want = p @ vv
    want.backward(g)
    torch.testing.assert_close(out, want.detach(), rtol=1e-12, atol=1e-12)
    for got, ref in ((dq, qq.grad), (dk, kk.grad), (dv, vv.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)
