"""The row logsumexp that the window-attention forward (K2) hands to its
backward (K3), in the plain versions of ops/cuda/window_attention.py,
against the JAX package on the CPU.

K2 writes each row's logsumexp lse (W, heads, N) on the training path, and
K3 rebuilds p = exp(s - lse) from it instead of sweeping the keys for the
rows' max and sum.  K3 takes D = rowsum(p dP) by one of two routes: in f32
from the forward's output, D = g . o; in bf16, whose stored output is
rounded too coarsely for that, from p and dP in the sweep that also gives
dQ = ((p dP) k - D p k) / sqrt(d).  The plain versions follow the kernels,
so here:

- the plain forward's output is the same bit for bit with and without lse,
  and its lse is torch.logsumexp of the plain scores within 1e-6 (base e
  for f32, base 2 for bf16, as the kernels keep it); its output matches
  the JAX kernel (`fused_window_attention`, Pallas interpret mode as
  tests/test_pallas.py runs it) at that test's 1e-5;
- the plain backward fed that lse matches the JAX kernel's vjp at 1e-4,
  the JAX tests' tolerance (tests/test_pallas.py), on both routes to D;
- a control: D from the bf16-rounded output moves dQ past one bf16 ulp +
  3e-5 of the exact route (the element-wise check chip_smoke.py and
  tests/test_torch_cuda.py hold the bf16 kernel to), where D from the f32
  output stays inside it, so the bf16 route has to stay as it is;
- the differentiable entry takes the lse op only where a gradient is
  wanted, and the served path's op elsewhere.

Shapes: tests/test_pallas.py's forward cases plus Swin3D-T's window
(4, 196, 3, 32, 2), as (W, N, heads, d, nW_img); inputs made with numpy
from a seed, the bias 0.1 N(0, 1) as there.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import bf16_ulp_excess
from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, window_attention, window_attention_bwd_reference,
    window_attention_fwd)

SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0),
          (4, 196, 3, 32, 2)]
BF16 = torch.bfloat16


def inputs(w, n, heads, d, nw, seed):
    """qkv, bias, mask and an output gradient g, f32 numpy."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((w, n, 3 * c)).astype(np.float32)
    bias = (rng.standard_normal((heads, n, n)) * 0.1).astype(np.float32)
    mask = (np.where(rng.uniform(0, 1, (nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if nw else None)
    g = rng.standard_normal((w, n, c)).astype(np.float32)
    return qkv, bias, mask, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def plain_scores(qkv, bias, mask, heads):
    """q k^T / sqrt(d) + bias + mask in f32, written out apart from the
    module's code: (W, heads, N, N)."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, _ = qkv.float().reshape(w, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = (q * d ** -0.5) @ k.transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(w // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(w, heads, n, n)
    return s


@pytest.fixture(scope="module", params=SHAPES,
                ids=lambda c: "x".join(map(str, c)))
def case(request):
    """The inputs, JAX's forward and its vjp at g (qkv's and the bias's
    gradients)."""
    w, n, heads, d, nw = request.param
    qkv, bias, mask, g = inputs(w, n, heads, d, nw, seed=n + nw)
    jmask = _j(mask)
    out, vjp = jax.vjp(
        lambda a, b: jax_fused_window_attention(a, b, jmask, heads),
        _j(qkv), _j(bias))
    return ((qkv, bias, mask, g, heads), np.asarray(out),
            [np.asarray(x) for x in vjp(_j(g))])


@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["f32", "bf16"])
def test_plain_forward_with_lse_keeps_out_and_gives_logsumexp(case, dtype):
    (qkv, bias, mask, _, heads), want, _ = case
    q = _t(qkv).to(dtype)
    plain = attention_core_reference(q, _t(bias), _t(mask), heads)
    out, lse = attention_core_reference(q, _t(bias), _t(mask), heads,
                                        with_lse=True)
    assert torch.equal(out.view(torch.uint8), plain.view(torch.uint8))
    assert lse.dtype == torch.float32
    assert lse.shape == (qkv.shape[0], heads, qkv.shape[1])
    ref = torch.logsumexp(plain_scores(q, _t(bias), _t(mask), heads), dim=-1)
    if dtype == BF16:  # base 2, as the bf16 kernels keep their scores
        ref = ref / math.log(2.0)
    torch.testing.assert_close(lse, ref, atol=1e-6, rtol=0)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("same_sweep", [False, True],
                         ids=["d_from_output", "same_sweep"])
def test_plain_backward_fed_lse_matches_jax_vjp(case, same_sweep):
    (qkv, bias, mask, g, heads), _, want = case
    out, lse = attention_core_reference(_t(qkv), _t(bias), _t(mask), heads,
                                        with_lse=True)
    # on the same-sweep route the output is not read
    got = window_attention_bwd_reference(
        _t(qkv), _t(bias), _t(mask), _t(g), heads, lse,
        None if same_sweep else out, same_sweep=same_sweep)
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-4)


def test_lse_op_on_the_cpu_is_the_plain_forward(case):
    (qkv, bias, mask, _, heads), _, _ = case
    for dtype in (torch.float32, BF16):
        q = _t(qkv).to(dtype)
        got = window_attention_fwd(q, _t(bias), _t(mask), heads)
        want = attention_core_reference(q, _t(bias), _t(mask), heads,
                                         with_lse=True)
        for x, y in zip(got, want):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def test_bf16_backward_defaults_to_the_same_sweep_route():
    """bf16 qkv takes D from p and dP, whatever output it is handed; f32
    takes it from the output and refuses to run without one."""
    qkv, bias, mask, g = inputs(4, 24, 3, 8, 2, seed=7)
    q16, g16 = _t(qkv).to(BF16), _t(g).to(BF16)
    out, lse = attention_core_reference(q16, _t(bias), _t(mask), 3,
                                        with_lse=True)
    want = window_attention_bwd_reference(q16, _t(bias), _t(mask), g16, 3,
                                          lse)
    got = window_attention_bwd_reference(q16, _t(bias), _t(mask), g16, 3,
                                         lse, torch.zeros_like(out))
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    with pytest.raises(ValueError, match="needs `out`"):
        window_attention_bwd_reference(_t(qkv), _t(bias), _t(mask), _t(g), 3,
                                       lse)


def test_d_from_the_bf16_output_misses_the_one_ulp_check():
    """On bf16 inputs at Swin3D-T's window, dQ with D from the f32 output
    stays within one bf16 ulp + 3e-5 of the exact route's, and with D from
    the output rounded to bf16 (what K2 bf16 stores) it does not."""
    qkv, bias, mask, g = inputs(4, 196, 3, 32, 2, seed=3)
    q16, g16 = _t(qkv).to(BF16), _t(g).to(BF16)
    b, m = _t(bias), _t(mask)
    o16, lse = attention_core_reference(q16, b, m, 3, with_lse=True)
    o32 = attention_core_reference(q16.float(), b, m, 3)
    want = window_attention_bwd_reference(q16, b, m, g16, 3, lse)[0]
    f32_out, bf16_out = (window_attention_bwd_reference(
        q16, b, m, g16, 3, lse, o, same_sweep=False)[0] for o in (o32, o16))
    assert want.dtype == f32_out.dtype == bf16_out.dtype == BF16
    assert bf16_ulp_excess(f32_out, want) <= 0
    assert bf16_ulp_excess(bf16_out, want) > 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_window_attention_writes_lse_only_for_a_gradient():
    """The differentiable entry runs the lse op where qkv or the bias wants
    a gradient, and the served path's op, without lse, elsewhere."""
    qkv, bias, mask, _ = inputs(4, 24, 3, 8, 2, seed=5)
    lse_op = "mar_torch.window_attention_lse.default"
    plain_op = "mar_torch.window_attention.default"
    q, b, m = _t(qkv), _t(bias), _t(mask)
    runs = {"grad": (q.clone().requires_grad_(), b, torch.enable_grad),
            "bias grad": (q, b.clone().requires_grad_(), torch.enable_grad),
            "no_grad": (q.clone().requires_grad_(), b, torch.no_grad),
            "frozen": (q, b, torch.enable_grad)}
    for name, (x, y, mode) in runs.items():
        with mode(), _Ops() as ops:
            out = window_attention(x, y, m, 3)
        wants_grad = name in ("grad", "bias grad")
        assert ops.counts[lse_op] == int(wants_grad), name
        assert ops.counts[plain_op] == int(not wants_grad), name
        assert out.requires_grad == wants_grad, name
