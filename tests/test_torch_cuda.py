"""The port's CUDA kernels against their plain versions, on a CUDA card.

Imports no JAX, so it runs on a GPU machine without it; tests/conftest.py
does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips.  Tolerance atol/rtol 1e-4: both sides are
f32 (TF32 off) and only the summation order differs; the window-attention
kernel at tests/test_pallas.py's small shapes is held to 1e-5, as there.
Its backward (K3) is held to its plain version at 1e-4 of the largest
gradient (the stage shapes sum over up to 2048 windows into dbias), K3
reading the row logsumexp (and in f32 the output) of K2's launch and the
plain backward the plain forward's own (chip_smoke.plain_bwd).  At N = 1
K3's dbias is 0 in exact arithmetic (p = 1, dS = dP - D) and both sides
return only rounding, so in f32 it is held to the largest dqkv there.
K2's output is the same bit for bit with and without that logsumexp,
which is within 1e-5 (plus 1e-6 of its magnitude) of the plain version's
in the instantiation's base (e for f32, 2 for bf16).  Their bf16 kernels
(bf16 tensor cores, p and dS in two bf16 pieces) are held
element by element within one bf16 ulp of the plain version's value plus
3e-5, a bound that a plain version with p rounded to bf16 is shown to
miss, and K3's bf16 launch is deterministic bit for bit.  The
roll (K4) only moves values, so it is held to torch.roll bit for bit, and a
served tri-modal forward gives the same logits with it as with torch.roll.
The `mar_torch::` custom ops equal a direct ctypes launch of their kernels
bit for bit, their fakes give the kernels' shapes and dtypes, the padded
int8 GEMM (`utils/quantize.int8_mm`) is exact, and an artifact exported on
the CPU scores on the card with nothing left on the CPU.  The bf16
self-attention kernels (ops/cuda/self_attention.py) are held to their
plain version in f32 on the same uniforms, output and dqkv within one bf16
ulp + 3e-5, their keep mask to `u < keep` bit for bit, each bit for bit
over two launches, and an XLS-R train step launches each once a layer.
"""

import pytest
import torch

from chip_smoke import (bf16_ulp_excess, k2_lse_check, p_rounded_reference,
                        plain_bwd)
from multimodalaggressionrecognition_tpu_torch.models import swin3d
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    _attention_mask)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference, framed_conv1d_trainable)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, fused_window_attention, window_attention,
    window_attention_bwd, window_attention_fwd)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.roll import (
    circular_roll, roll, roll_reference)
from multimodalaggressionrecognition_tpu_torch.ops.resample import (
    resample_poly)
from multimodalaggressionrecognition_tpu_torch.ops.stft import spectrogram
from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
    launch_counts)

# (B, L, F, hop, pad, C): tests/test_pallas.py's shapes, a non-multiple
# F/hop with a ragged C tile, and a batch past one T tile per row; the STFT's
# width (C=514, F=512, hop 256) and ragged edges: C=1, T under one 128-frame
# tile, F < 8 with hop 3, hops 7 and 12 (not multiples of 8) and T = 1; the
# stem as the b8 train step calls it (a grid that takes the 64-frame tile);
# the STFT as the spectrogram VGG's b16 train step calls it (5 s clips)
SHAPES = [(2, 8000, 160, 40, 80, 64), (2, 8000, 512, 256, 0, 128),
          (2, 8000, 10, 5, 0, 512), (2, 8000, 147, 40, 3, 24),
          (3, 1000, 7, 3, 0, 70), (1, 160, 160, 40, 80, 64),
          (2, 8448, 512, 256, 0, 514), (3, 5000, 160, 40, 80, 1),
          (2, 1000, 160, 40, 80, 64), (2, 3001, 5, 3, 2, 33),
          (2, 4003, 64, 7, 1, 70), (2, 4000, 48, 12, 4, 40),
          (3, 160, 160, 40, 0, 64), (8, 80000, 160, 40, 80, 64),
          (16, 80512, 512, 256, 0, 514)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("b,length,f,s,p,c", SHAPES)
def test_framed_conv1d_kernel_matches_plain(cuda, b, length, f, s, p, c,
                                            epilogue):
    g = torch.Generator().manual_seed(f * 1000 + c)
    x = torch.randn((b, length), generator=g).to(cuda)
    w = (torch.randn((f, c), generator=g) * 0.05).to(cuda)
    bias = torch.randn((c,), generator=g).to(cuda)
    scale = torch.linspace(0.5, 1.5, c, device=cuda) if epilogue else None
    shift = torch.linspace(-0.2, 0.2, c, device=cuda) if epilogue else None
    before = launch_counts["framed_conv1d"]
    got = framed_conv1d(x, w, bias, f, s, p, scale, shift, relu=epilogue)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == before + 1
    ref = framed_conv1d_reference(x, w, bias, f, s, p, scale, shift, epilogue)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_framed_conv1d_kernel_is_deterministic(cuda):
    """Two launches on the same inputs (the CNN1D stem at b32) agree bit for
    bit: each output's sum runs in a fixed order, without atomics."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((32, 80000), generator=g).to(cuda)
    w = (torch.randn((160, 64), generator=g) * 0.05).to(cuda)
    bias = torch.randn((64,), generator=g).to(cuda)
    first = framed_conv1d(x, w, bias, 160, 40, 80)
    again = framed_conv1d(x, w, bias, 160, 40, 80)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("length,f,s,p,c", [(80512, 512, 256, 0, 514),
                                            (220975, 475, 441, 0, 160)])
def test_framed_conv1d_frame_tiles_agree_bitwise(cuda, length, f, s, p, c):
    """At b32 the STFT and the resample take the 128-frame tile, one clip
    the 64-frame tile; each output's sum runs in the same order in both, so
    the clip's frames agree bit for bit."""
    g = torch.Generator().manual_seed(f + c)
    x = torch.randn((32, length), generator=g).to(cuda)
    w = (torch.randn((f, c), generator=g) * 0.05).to(cuda)
    bias = torch.randn((c,), generator=g).to(cuda)
    full = framed_conv1d(x, w, bias, f, s, p)
    one = framed_conv1d(x[:1], w, bias, f, s, p)
    torch.cuda.synchronize()
    assert torch.equal(full[:1], one)


@pytest.mark.cuda
def test_spectrogram_on_the_card_matches_the_cpu(cuda):
    """ops/stft.spectrogram of 5 s clips at 16 kHz (n_fft 512: 257 x 313),
    the STFT through K1 on the card against the plain version on the CPU,
    within 1e-4 of the largest power."""
    g = torch.Generator().manual_seed(11)
    wav = torch.randn((2, 80000), generator=g) * 0.1
    want = spectrogram(wav, n_fft=512)
    before = launch_counts["framed_conv1d"]
    got = spectrogram(wav.to(cuda), n_fft=512)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == before + 1
    assert got.shape == (2, 257, 313)
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("orig,new,length", [(44100, 16000, 220500),
                                             (48000, 16000, 3000),
                                             (8000, 16000, 1001)])
def test_resample_poly_on_the_card_matches_the_cpu(cuda, orig, new, length):
    """ops/resample.resample_poly (K1's resample route) on the card against
    the same call on the CPU, 1e-4."""
    g = torch.Generator().manual_seed(length)
    x = torch.randn((3, length), generator=g) * 0.3
    want = resample_poly(x, orig, new)
    before = launch_counts["framed_conv1d"]
    got = resample_poly(x.to(cuda), orig, new)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == before + 1
    assert got.shape == want.shape == (3, -(-new * length // orig))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_framed_conv1d_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 400), device=cuda)
    w = torch.zeros((16, 8), device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        framed_conv1d(x.double(), w, b, 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        framed_conv1d(torch.zeros((400, 2), device=cuda).t(), w, b, 16, 4)
    with pytest.raises(ValueError, match="shape"):
        framed_conv1d(x, w, b, 15, 4)
    with pytest.raises(ValueError, match="on cpu"):
        framed_conv1d(x, w.cpu(), b, 16, 4)


# (W, N, heads, d, nW_img, tolerance): tests/test_pallas.py's shapes
# (random masks), then Swin3D-T's four stages served at batch 8, with the
# shifted-window masks of the padded grids (4, 28, 28) and (4, 14, 14)
K2_SHAPES = [(8, 24, 3, 8, 4, 1e-5), (6, 49, 3, 32, 3, 1e-5),
             (4, 12, 2, 16, 0, 1e-5),
             (2048, 196, 3, 32, 16, 1e-4), (2048, 196, 3, 32, 0, 1e-4),
             (512, 196, 6, 32, 4, 1e-4), (512, 196, 6, 32, 0, 1e-4),
             (128, 196, 12, 32, 0, 1e-4), (128, 64, 24, 32, 0, 1e-4)]
STAGE_GRIDS = {16: (4, 28, 28), 4: (4, 14, 14)}


def k2_inputs(w, n, heads, d, nw, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = heads * d
    qkv = torch.randn((w, n, 3 * c), generator=g)
    bias = torch.randn((heads, n, n), generator=g) * 0.1
    mask = None
    if nw and n == 196:  # a stage shape: the real shifted-window mask
        mask = torch.from_numpy(_attention_mask(*STAGE_GRIDS[nw], (4, 7, 7),
                                                (0, 3, 3)))
    elif nw:
        mask = torch.where(torch.rand((nw, n, n), generator=g) > 0.7,
                           -100.0, 0.0)
    return [t if t is None else t.to(device) for t in (qkv, bias, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw,tol", K2_SHAPES)
def test_window_attention_kernel_matches_plain(cuda, w, n, heads, d, nw, tol):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n * 100 + d)
    if mask is not None:
        assert mask.shape == (nw, n, n)
    before = launch_counts["window_attention"]
    got = fused_window_attention(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    assert launch_counts["window_attention"] == before + 1
    ref = attention_core_reference(qkv, bias, mask, heads)
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)


# K2 and K3 at ragged 16- and 8-token tiles: (W, N, heads, d, nW_img) for
# N in {1, 17, 392} x d in {8, 16, 32}, unmasked and with random masks
EDGE_SHAPES = [(4, n, 2, d, nw) for n in (1, 17, 392) for d in (8, 16, 32)
               for nw in (0, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", EDGE_SHAPES)
def test_window_attention_kernel_matches_plain_at_edge_shapes(cuda, w, n,
                                                              heads, d, nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n * 100 + d)
    got = fused_window_attention(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    ref = attention_core_reference(qkv, bias, mask, heads)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("w,n,heads,d,nw", [s[:5] for s in K2_SHAPES]
                         + EDGE_SHAPES)
def test_window_attention_kernel_with_lse(cuda, w, n, heads, d, nw, dtype):
    """K2 with the rows' logsumexp: one launch under the dtype's key, the
    output bit for bit the launch's without it, lse within 1e-5 (plus 1e-6
    of its magnitude) of the plain version's."""
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n * 100 + d)
    qkv = qkv.to(dtype)
    out = fused_window_attention(qkv, bias, mask, heads)
    key = "window_attention" + (".bf16" if dtype == torch.bfloat16 else "")
    before = launch_counts[key]
    k2_lse_check(f"k2 {dtype}", qkv, bias, mask, heads, out)
    assert launch_counts[key] == before + 1


@pytest.mark.cuda
def test_window_attention_rejects_what_the_kernel_does_not_take(cuda):
    qkv, bias, mask = k2_inputs(8, 24, 3, 8, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_window_attention(qkv.double(), bias, mask, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_window_attention(qkv, bias.transpose(1, 2), mask, 3)
    with pytest.raises(ValueError, match="on cpu"):
        fused_window_attention(qkv, bias.cpu(), mask, 3)
    with pytest.raises(ValueError, match="nW_img"):
        fused_window_attention(qkv, bias, mask[:3], 3)
    with pytest.raises(ValueError, match="multiple of heads"):
        fused_window_attention(qkv, bias[:1].expand(5, 24, 24).contiguous(),
                               None, 5)
    wide, wide_bias, _ = k2_inputs(2, 24, 1, 64, 0, cuda)  # d = 64
    with pytest.raises(ValueError, match="head dim"):
        fused_window_attention(wide, wide_bias, None, 1)
    long, long_bias, _ = k2_inputs(1, 393, 1, 8, 0, cuda)  # N > 392
    with pytest.raises(ValueError, match="tokens"):
        fused_window_attention(long, long_bias, None, 1)


@pytest.mark.cuda
def test_framed_conv1d_autograd_on_the_card_matches_plain_autograd(cuda):
    g = torch.Generator().manual_seed(3)
    x, w, b = (torch.randn((2, 4000), generator=g),
               torch.randn((160, 64), generator=g) * 0.05,
               torch.randn((64,), generator=g))
    out = {}
    for name, dev, fn in (("kernel", cuda, framed_conv1d_trainable),
                          ("plain", cuda, framed_conv1d_reference)):
        args = [t.to(dev).requires_grad_() for t in (x, w, b)]
        torch.sum(fn(*args, 160, 40, 80) ** 2).backward()
        out[name] = [a.grad for a in args]
    for got, ref in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(got, ref, atol=2e-2, rtol=1e-4)


# K3: (W, N, heads, d, nW_img): tests/test_pallas.py's gradient shapes, a
# clamped N=64 window, then Swin3D-T's stage shapes trained at batch 8
K3_SHAPES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2),
             (16, 392, 3, 32, 4), (2048, 196, 3, 32, 16),
             (2048, 196, 3, 32, 0), (512, 196, 6, 32, 4),
             (128, 196, 12, 32, 0), (128, 64, 24, 32, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", K3_SHAPES)
def test_window_attention_bwd_kernel_matches_plain(cuda, w, n, heads, d, nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n + d)
    g = k3_grad(w, n, heads, d, cuda)
    out, lse = window_attention_fwd(qkv, bias, mask, heads)
    before = launch_counts["window_attention_bwd"]
    got = window_attention_bwd(qkv, bias, mask, g, heads, lse, out)
    torch.cuda.synchronize()
    assert launch_counts["window_attention_bwd"] == before + 1
    want = plain_bwd(qkv, bias, mask, g, heads)
    for x, y in zip(got, want):
        tol = 1e-4 * y.abs().max().item()
        torch.testing.assert_close(x, y, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [0, 3])
def test_window_attention_function_on_the_card_matches_autograd(cuda, nw):
    """The autograd Function (K2 forward, K3 backward) against autograd
    through the plain forward, both on the card."""
    qkv, bias, mask = k2_inputs(6, 49, 3, 32, nw, cuda, seed=11)
    grads = {}
    for name, fn in (("kernel", window_attention),
                     ("plain", attention_core_reference)):
        q = qkv.clone().requires_grad_()
        b = bias.clone().requires_grad_()
        torch.sum(fn(q, b, mask, 3) ** 2).backward()
        grads[name] = (q.grad, b.grad)
    for x, y in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


def k3_grad(w, n, heads, d, device):
    return torch.randn((w, n, heads * d),
                       generator=torch.Generator().manual_seed(w)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", EDGE_SHAPES)
def test_window_attention_bwd_kernel_matches_plain_at_edge_shapes(
        cuda, w, n, heads, d, nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n + d)
    g = k3_grad(w, n, heads, d, cuda)
    out, lse = window_attention_fwd(qkv, bias, mask, heads)
    got = window_attention_bwd(qkv, bias, mask, g, heads, lse, out)
    torch.cuda.synchronize()
    want = plain_bwd(qkv, bias, mask, g, heads)
    # at N = 1 dbias is 0 in exact arithmetic (p = 1, dS = dP - D), and
    # both sides return rounding: it is held to dqkv's largest there
    for x, y, ref in zip(got, want, (want[0], want[0] if n == 1 else want[1])):
        tol = 1e-4 * ref.abs().max().item()
        torch.testing.assert_close(x, y, atol=tol, rtol=0)


@pytest.mark.cuda
def test_window_attention_bwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs (stage 0's shifted block) agree bit
    for bit: dbias is summed in a fixed order, without atomics."""
    w, n, heads, d, nw = 2048, 196, 3, 32, 16
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=5)
    g = k3_grad(w, n, heads, d, cuda)
    out, lse = window_attention_fwd(qkv, bias, mask, heads)
    first = window_attention_bwd(qkv, bias, mask, g, heads, lse, out)
    again = window_attention_bwd(qkv, bias, mask, g, heads, lse, out)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


# (B, T, H, W, C, shifts): Swin3D-T's two shifted stages of the b8 tower,
# both signs; the scalar path (C = 3, 5) with odd H and W and a T shift;
# shift 0 on one axis; B = 1
ROLL_CASES = [(128, 4, 28, 28, 96, (0, 3, 3)), (128, 4, 28, 28, 96, (0, -3, -3)),
              (128, 4, 14, 14, 192, (0, 3, 3)),
              (128, 4, 14, 14, 192, (0, -3, -3)),
              (2, 4, 7, 9, 3, (0, 3, 4)), (3, 5, 9, 11, 5, (2, -4, 6)),
              (2, 4, 14, 14, 96, (0, 0, 3)), (1, 4, 28, 28, 96, (0, 3, 3)),
              (2, 3, 9, 11, 8, (1, 4, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,w,c,shifts", ROLL_CASES)
def test_roll_kernel_equals_torch_roll(cuda, b, t, h, w, c, shifts):
    x = torch.randn((b, t, h, w, c), device=cuda)
    before = launch_counts["roll"]
    got = circular_roll(x, shifts)
    torch.cuda.synchronize()
    assert launch_counts["roll"] == before + 1
    assert torch.equal(got, roll_reference(x, shifts))


@pytest.mark.cuda
def test_roll_kernel_takes_a_misaligned_view(cuda):
    """A contiguous view 4 bytes off a 16-byte boundary takes the scalar
    path."""
    x = torch.randn(1 + 2 * 4 * 6 * 6 * 8, device=cuda)[1:].view(2, 4, 6, 6, 8)
    assert torch.equal(circular_roll(x, (0, 3, 3)),
                       roll_reference(x, (0, 3, 3)))


@pytest.mark.cuda
def test_roll_backward_is_the_opposite_roll(cuda):
    x = torch.randn((128, 4, 28, 28, 96), device=cuda, requires_grad=True)
    g = torch.randn_like(x)
    before = launch_counts["roll"]
    roll(x, (0, 3, 3)).backward(g)
    torch.cuda.synchronize()
    assert launch_counts["roll"] == before + 2
    assert torch.equal(x.grad, roll_reference(g, (0, -3, -3)))


@pytest.mark.cuda
def test_roll_kernel_is_deterministic(cuda):
    x = torch.randn((128, 4, 14, 14, 192), device=cuda)
    assert torch.equal(circular_roll(x, (0, 3, 3)),
                       circular_roll(x, (0, 3, 3)))


@pytest.mark.cuda
def test_roll_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn((2, 4, 6, 6, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        circular_roll(x.transpose(2, 3), (0, 1, 1))
    with pytest.raises(TypeError, match="float32"):
        circular_roll(x.half(), (0, 1, 1))


@pytest.mark.cuda
def test_trimodal_served_logits_are_unchanged_against_torch_roll(
        cuda, monkeypatch):
    """The tri-modal model at full width, served (eval mode) at b2 with 16
    frames at 112 px: its shifted Swin blocks roll through K4 (4 launches a
    forward) and give the logits of the same weights rolled by torch.roll."""
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)

    cfg = MultimodalConfig(video_frames=16)
    model = seeded_init_(build_model(cfg, ("audio", "text", "video")), 0)
    model = model.to(cuda).eval()
    g = torch.Generator().manual_seed(1)
    present = torch.ones(2)
    batch = {"audio": torch.randn((2, 80000), generator=g) * 0.1,
             "text": torch.randn((2, 48, 768), generator=g),
             "video": torch.randn((2, 16, 112, 112, 3), generator=g)}
    batch = {m: {"data": d.to(cuda), "present": present.to(cuda)}
             for m, d in batch.items()}
    with torch.inference_mode():
        before = launch_counts["roll"]
        got = model(batch)
        torch.cuda.synchronize()
        assert launch_counts["roll"] == before + 4
        monkeypatch.setattr(swin3d, "roll", roll_reference)
        want = model(batch)
    assert sorted(got) == sorted(want) == ["phys", "verb"]
    for head in want:
        assert torch.equal(got[head], want[head]), head


@pytest.mark.cuda
def test_window_attention_kernel_at_the_extraction_stage0_shape(cuda):
    """K2 as extract_features --backbone swin3d_t calls it at stage 0: 4
    clips x 19 windows of 16 frames -> 76 x (8, 28, 28) patches, in full
    (8, 7, 7) windows (N = 392): W = 1216, 3 heads, d 32, the shifted
    block's real mask (16 window slots), 1e-4."""
    g = torch.Generator().manual_seed(3)
    w, n, heads, d = 1216, 392, 3, 32
    qkv = torch.randn((w, n, 3 * heads * d), generator=g).to(cuda)
    bias = (torch.randn((heads, n, n), generator=g) * 0.1).to(cuda)
    # T' = 8 fills one window, so the tower does not shift T
    mask = torch.from_numpy(_attention_mask(8, 28, 28, (8, 7, 7),
                                            (0, 3, 3))).to(cuda)
    assert mask.shape == (16, n, n)
    got = fused_window_attention(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    ref = attention_core_reference(qkv, bias, mask, heads)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_r3d_forward_on_the_card_matches_the_cpu(cuda):
    """R3DWithBboxes (eval mode, seeded weights) at b2 x 16 frames x 112 px
    with a box mask: cuDNN's f32 convs (TF32 off) against the CPU's, 1e-3
    of the largest logit; no hand-written kernel runs."""
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.models.r3d import (
        R3DWithBboxes)

    model = seeded_init_(R3DWithBboxes(4), 0).eval()
    g = torch.Generator().manual_seed(2)
    frames = torch.rand((2, 16, 112, 112, 3), generator=g)
    mask = torch.zeros((2, 16, 112, 112, 1))
    mask[:, :, 20:90, 30:70] = 1.0
    with torch.inference_mode():
        want = model(frames, mask)
        before = dict(launch_counts)
        got = model.to(cuda)(frames.to(cuda), mask.to(cuda)).cpu()
    assert dict(launch_counts) == before
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
def test_augment_is_deterministic_for_a_seed(cuda):
    """The port's paired augmentation (numpy, no OpenCV: the card's machine
    has none) gives the same frames and boxes twice for one seed."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.data.augment import (
        PairedVideoAugment)

    rng = np.random.default_rng(0)
    video = rng.uniform(0, 1, (8, 112, 112, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[8, 8, 40, 40]], np.float32), (8, 1))
    runs = []
    for _ in range(2):
        augment = PairedVideoAugment(seed=5, perspective_p=1.0)
        runs.append([augment(video, boxes) for _ in range(3)])
    for (v0, b0), (v1, b1) in zip(*runs):
        np.testing.assert_array_equal(v0, v1)
        np.testing.assert_array_equal(b0, b1)
    assert not np.array_equal(runs[0][0][0], video)


@pytest.fixture(scope="module")
def trimodal_run(tmp_path_factory):
    """A tri-modal port run trained for one epoch on the CPU (8 frames at
    32 px, 24 000 samples, the Swin tower fine-tuned)."""
    import os

    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_multimodal)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("run")
    root, saving = str(tmp / "avabos"), str(tmp / "runs")
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    generate_synthetic_avabos(root, num_clusters=2, samples_per_cluster=4,
                              seed=9, audio_len=24000, video_frames=8,
                              video_hw=32)
    train_multimodal.main([
        "--dataset_root", root, "--batch_size", "4", "--epoch_num", "1",
        "--audio_samples", "24000", "--video_frames", "8",
        "--video_size", "32", "--modalities", "audio,text,video",
        "--video_freeze", "false", "--saving_dir", saving, "--run_name", "t",
        "--log_console", "false", "--device", "cpu"])
    return tmp, os.path.join(saving, "t")


@pytest.mark.cuda
def test_evaluate_on_the_card_matches_the_cpu(cuda, trimodal_run):
    """cli.evaluate --from_run of the tri-modal run: the card's metrics
    equal the CPU's and its loss is within 1e-3; K1, K2 and K4 launch."""
    import os

    from multimodalaggressionrecognition_tpu_torch.cli import evaluate

    tmp, run_dir = trimodal_run
    args = ["--from_run", run_dir, "--path_to_checkpoint",
            os.path.join(run_dir, "checkpoint_best_phys"),
            "--saving_dir", str(tmp / "eval")]
    want = evaluate.main(args + ["--device", "cpu"])
    launch_counts.clear()
    got = evaluate.main(args)  # CUDA by default
    counts = dict(launch_counts)
    assert all(counts.get(k, 0) >= 1
               for k in ("framed_conv1d", "window_attention", "roll"))
    assert sorted(got) == sorted(want) == ["phys", "verb"]
    for head in want:
        for metric in ("accuracy", "UAR", "UAP", "UAF1"):
            assert got[head][metric] == want[head][metric], (head, metric)
        assert abs(got[head]["loss"] - want[head]["loss"]) <= 1e-3


@pytest.mark.cuda
def test_predict_on_the_card_matches_the_cpu(cuda, trimodal_run, capsys):
    """cli.predict --from_run on wavs, text .npy and 48 px uint8-range
    video .npy: the card's probabilities within 1e-3 of the CPU's."""
    import json
    import os

    import numpy as np
    from scipy.io import wavfile

    from multimodalaggressionrecognition_tpu_torch.cli import predict

    tmp, run_dir = trimodal_run
    rng = np.random.default_rng(3)
    dirs = {m: tmp / f"clips_{m}" for m in ("audio", "text", "video")}
    for d in dirs.values():
        d.mkdir()
    for i in range(3):
        wavfile.write(str(dirs["audio"] / f"c{i}.wav"), 44100,
                      (rng.standard_normal(44100) * 3000).astype(np.int16))
        np.save(dirs["text"] / f"c{i}.npy",
                rng.standard_normal((20, 768)).astype(np.float32))
        np.save(dirs["video"] / f"c{i}.npy",
                (rng.random((6, 48, 48, 3)) * 255).astype(np.float32))
    args = ["--from_run", run_dir, "--path_to_checkpoint",
            os.path.join(run_dir, "checkpoint_best_phys"),
            "--modalities", "audio,text,video", "--batch_size", "2"]
    for m, d in dirs.items():
        args += [f"--{m}", str(d)]
    capsys.readouterr()
    outs = {}
    for device in ("cpu", "cuda"):
        launch_counts.clear()
        predict.main(args + ["--device", device])
        outs[device] = [json.loads(line) for line in
                        capsys.readouterr().out.strip().splitlines()]
    assert all(launch_counts.get(k, 0) >= 1
               for k in ("framed_conv1d", "window_attention", "roll"))
    assert len(outs["cuda"]) == len(outs["cpu"]) == 3
    for g, w in zip(outs["cuda"], outs["cpu"]):
        assert g["clip"] == w["clip"]
        for key in ("phys_prob_aggr", "verb_prob_aggr"):
            assert abs(g[key] - w[key]) <= 1e-3, (g, w)


@pytest.mark.cuda
def test_doctor_smoke_on_the_card(cuda, capsys):
    """doctor --smoke: the card listed, K4 built and bit for bit equal to
    torch.roll."""
    from multimodalaggressionrecognition_tpu_torch.cli import doctor

    report = doctor.main(["--smoke"])
    assert report["backend"] == "cuda" and report["devices"]
    assert report["smoke"]["roll"]["bitwise_equal_to_torch_roll"] is True
    assert "roll" in report["kernels"]["built"]


# K2, K3 and K4 in bf16: qkv (and g) in bf16, each result rounded once to
# bf16; K2 and K3 on the bf16 tensor cores to f32 accuracy.  Held to the
# plain versions (f32 math, the output rounded to bf16) within 1e-2 of each
# output's largest value (one bf16 rounding of an f32 result is 2^-8
# relative) and, tighter, element by element within one bf16 ulp of the
# plain version's value plus 3e-5 (the two f32-accurate results round to
# bf16 at most one ulp apart; a kernel that took p, and dS, in one bf16
# piece misses it: p_rounded_reference is held to fail it; both are
# chip_smoke.py's, which runs the same check); dbias (f32 for an f32
# bias) within 1e-4 of its largest, as the f32 K3.  The roll bit for bit.
BF16_K2_SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 17, 2, 16, 2),
                  (2048, 196, 3, 32, 16), (512, 196, 6, 32, 4),
                  (128, 64, 24, 32, 0), (16, 392, 3, 32, 4)]


def _bf16_close(got, want):
    assert got.dtype == want.dtype
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * scale, (err, scale)


def _bf16_elementwise(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    excess = bf16_ulp_excess(got, want)
    assert excess <= 0, excess


def _bf16_dbias_close(q16, bias, mask, g16, heads):
    """K3's dbias for an f32 bias stays f32: within 1e-4 of its largest."""
    lse = window_attention_fwd(q16, bias, mask, heads)[1]
    db = window_attention_bwd(q16, bias, mask, g16, heads, lse)[1]
    want = plain_bwd(q16, bias, mask, g16, heads)[1]
    assert db.dtype == torch.float32
    torch.testing.assert_close(db, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", BF16_K2_SHAPES)
def test_window_attention_bf16_kernels_match_plain(cuda, w, n, heads, d, nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n + d)
    q16, g16 = qkv.bfloat16(), k3_grad(w, n, heads, d, cuda).bfloat16()
    b16 = bias.bfloat16()  # a cast model's table, for the forward and back
    before = dict(launch_counts)
    got, lse = window_attention_fwd(q16, b16, mask, heads)
    dq, db = window_attention_bwd(q16, b16, mask, g16, heads, lse)
    torch.cuda.synchronize()
    # the bf16 instantiations ran, under their own keys, and no f32 one
    for key in ("window_attention", "window_attention_bwd"):
        assert launch_counts[f"{key}.bf16"] == before.get(
            f"{key}.bf16", 0) + 1
        assert launch_counts[key] == before.get(key, 0)
    assert got.dtype == dq.dtype == db.dtype == torch.bfloat16
    want = attention_core_reference(q16, b16, mask, heads)
    _bf16_close(got, want)
    _bf16_elementwise(got, want)
    want_dq, want_db = plain_bwd(q16, b16, mask, g16, heads)
    _bf16_close(dq, want_dq)
    _bf16_elementwise(dq, want_dq)
    _bf16_close(db, want_db)
    _bf16_dbias_close(q16, bias, mask, g16, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", [(6, 49, 3, 32, 3),
                                            (2048, 196, 3, 32, 16),
                                            (16, 392, 3, 32, 4)])
def test_bf16_elementwise_check_fails_p_rounded_to_bf16(cuda, w, n, heads, d,
                                                        nw):
    """The kernels pass the element-wise check where the plain version with
    p and dS rounded to bf16 fails it: the check tells the two-piece design
    from a one-pass one."""
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n + d)
    q16, g16 = qkv.bfloat16(), k3_grad(w, n, heads, d, cuda).bfloat16()
    lse = window_attention_fwd(q16, bias, mask, heads)[1]
    want = (attention_core_reference(q16, bias, mask, heads),
            plain_bwd(q16, bias, mask, g16, heads)[0])
    got = (fused_window_attention(q16, bias, mask, heads),
           window_attention_bwd(q16, bias, mask, g16, heads, lse)[0])
    for x, y, c in zip(got, want,
                       p_rounded_reference(q16, bias, mask, g16, heads)):
        assert bf16_ulp_excess(x, y) <= 0
        assert bf16_ulp_excess(c, y) > 0
    # nor does D from the bf16 output, where the f32 backward takes it
    assert bf16_ulp_excess(plain_bwd(q16, bias, mask, g16, heads,
                                     same_sweep=False)[0], want[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", EDGE_SHAPES)
def test_window_attention_bf16_kernels_at_edge_shapes(cuda, w, n, heads, d,
                                                      nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n * 100 + d)
    q16, g16 = qkv.bfloat16(), k3_grad(w, n, heads, d, cuda).bfloat16()
    before = dict(launch_counts)
    got, lse = window_attention_fwd(q16, bias, mask, heads)
    dq, _ = window_attention_bwd(q16, bias, mask, g16, heads, lse)
    torch.cuda.synchronize()
    for key in ("window_attention", "window_attention_bwd"):
        assert launch_counts[f"{key}.bf16"] == before.get(
            f"{key}.bf16", 0) + 1
    _bf16_elementwise(got, attention_core_reference(q16, bias, mask, heads))
    _bf16_elementwise(dq, plain_bwd(q16, bias, mask, g16, heads)[0])
    _bf16_dbias_close(q16, bias, mask, g16, heads)


@pytest.mark.cuda
def test_window_attention_bwd_bf16_kernel_is_deterministic(cuda):
    """Two bf16 launches on the same inputs (stage 0's shifted block) agree
    bit for bit, dbias included (bf16 for a bf16 bias, f32 for an f32)."""
    w, n, heads, d, nw = 2048, 196, 3, 32, 16
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=5)
    q16, g16 = qkv.bfloat16(), k3_grad(w, n, heads, d, cuda).bfloat16()
    for b in (bias, bias.bfloat16()):
        lse = window_attention_fwd(q16, b, mask, heads)[1]
        first = window_attention_bwd(q16, b, mask, g16, heads, lse)
        again = window_attention_bwd(q16, b, mask, g16, heads, lse)
        torch.cuda.synchronize()
        for x, y in zip(first, again):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.cuda
def test_window_attention_takes_only_f32_or_bf16(cuda):
    qkv, bias, mask = k2_inputs(8, 24, 3, 8, 4, cuda)
    g = k3_grad(8, 24, 3, 8, cuda)
    out, lse = window_attention_fwd(qkv, bias, mask, 3)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fused_window_attention(qkv.to(dtype), bias, mask, 3)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            window_attention_bwd(qkv.to(dtype), bias, mask, g.to(dtype), 3,
                                 lse, out)
    with pytest.raises(TypeError, match="g must be torch.bfloat16"):
        window_attention_bwd(qkv.bfloat16(), bias, mask, g, 3, lse)
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        window_attention_bwd(qkv, bias, mask, g, 3, lse.double(), out)
    with pytest.raises(ValueError, match="the forward's output"):
        window_attention_bwd(qkv, bias, mask, g, 3, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,w,c,shifts", ROLL_CASES)
def test_roll_bf16_kernel_equals_torch_roll(cuda, b, t, h, w, c, shifts):
    x = torch.randn((b, t, h, w, c), device=cuda).bfloat16()
    before = dict(launch_counts)
    got = circular_roll(x, shifts)
    assert launch_counts["roll.bf16"] == before.get("roll.bf16", 0) + 1
    assert launch_counts["roll"] == before.get("roll", 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       roll_reference(x, shifts).view(torch.int16))
    xg = x.clone().requires_grad_(True)
    g = torch.randn_like(x)
    roll(xg, shifts).backward(g)
    assert torch.equal(xg.grad, roll_reference(g, tuple(-s for s in shifts)))


@pytest.mark.cuda
def test_roll_bf16_kernel_takes_a_misaligned_view(cuda):
    """A view 2 bytes off a 16-byte boundary takes the 2-byte path."""
    x = torch.randn(1 + 2 * 4 * 6 * 6 * 16, device=cuda).bfloat16()
    x = x[1:].view(2, 4, 6, 6, 16)
    assert torch.equal(circular_roll(x, (0, 3, 3)),
                       roll_reference(x, (0, 3, 3)))


@pytest.mark.cuda
def test_bf16_finetune_step_on_the_card(cuda):
    """One bf16 step of the tri-modal fine-tune (Swin unfrozen, remat on)
    at full width, b2 with 16 frames: K1 once, K2 twice per block (remat's
    recompute), K3 and K4 as in f32; the loss within 5 % of the same f32
    step (tests/test_precision.py:168); master parameters, their
    gradients, the optimizer's moments and BatchNorm's statistics f32."""
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    cfg = MultimodalConfig(video_frames=16, video_freeze=False)
    g = torch.Generator().manual_seed(2)
    n = 2
    data = {"audio": torch.randn((n, 80000), generator=g) * 0.1,
            "text": torch.randn((n, 48, 768), generator=g),
            "video": torch.randn((n, 16, 112, 112, 3), generator=g)}
    batch = {"modalities": {m: {"data": d.to(cuda),
                                "present": torch.ones(n, device=cuda)}
                            for m, d in data.items()},
             "labels": {h: torch.tensor([0, 1], device=cuda)
                        for h in ("phys", "verb")},
             "label_mask": {h: torch.ones(n, device=cuda)
                            for h in ("phys", "verb")},
             "sample_mask": torch.ones(n, device=cuda)}
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    losses, counts = {}, {}
    for dtype in (None, torch.bfloat16):
        model = seeded_init_(build_model(cfg, ("audio", "text", "video")), 0)
        state = create_train_state(model,
                                   OptimizerConfig(learning_rate=1e-4), cuda)
        set_generator(state.model, torch.Generator(cuda).manual_seed(0))
        launch_counts.clear()
        losses[dtype] = train_step(state, batch, specs, 2,
                                   compute_dtype=dtype)["total_loss"].item()
        torch.cuda.synchronize()
        counts[dtype] = dict(launch_counts)
    # the bf16 step runs the bf16 instantiations of K2, K3 and K4 as often
    # as the f32 step runs the f32 ones; K1 stays f32 (cast around it)
    assert counts[torch.bfloat16] == {
        k if k == "framed_conv1d" else f"{k}.bf16": v
        for k, v in counts[None].items()}
    assert counts[None]["framed_conv1d"] == 1
    assert counts[None]["window_attention"] == 2 * counts[None][
        "window_attention_bwd"]
    rel = abs(losses[torch.bfloat16] - losses[None]) / abs(losses[None])
    assert rel < 0.05, losses
    for p in state.model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    for st in state.optimizer.inner.state.values():
        for v in st.values():
            assert not v.is_floating_point() or v.dtype == torch.float32
    for buf in state.model.buffers():
        assert buf.dtype == torch.float32


def _direct_launch(name, signatures, entry, args, out):
    """The kernel launched straight through ctypes, as the wrappers did
    before the custom ops: the reference the op's CUDA body must equal."""
    from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
        check_status, load_library)

    lib = load_library(name, signatures)
    stream = torch.cuda.current_stream().cuda_stream
    check_status(name, getattr(lib, entry)(*args, stream))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_custom_ops_equal_the_direct_kernel_launch(cuda):
    """mar_torch::framed_conv1d, ::window_attention (f32 and bf16) and
    ::roll launch the same kernels as a direct ctypes call, bit for bit,
    and each counts one launch."""
    import ctypes

    from multimodalaggressionrecognition_tpu_torch.ops.cuda import (
        framed_conv as fc, roll as rl, window_attention as wa)

    g = torch.Generator().manual_seed(40)
    x = torch.randn((8, 80000), generator=g).to(cuda)
    w = (torch.randn((160, 64), generator=g) * 0.1).to(cuda)
    b = torch.randn(64, generator=g).to(cuda)
    s = torch.rand(64, generator=g).to(cuda) + 0.5
    launch_counts.clear()
    got = torch.ops.mar_torch.framed_conv1d(x, w, b, 160, 40, 80, s, None,
                                            True)
    want = torch.empty_like(got)
    _direct_launch("framed_conv", fc._SIGNATURES, "framed_conv1d_f32",
                   (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
                    None, want.data_ptr(), 8, 80000, 160, 64, got.shape[1],
                    40, 80, 1), want)
    assert torch.equal(got, want)
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qkv = torch.randn((32, 196, 288), generator=g).to(cuda, dtype)
        bias = torch.randn((3, 196, 196), generator=g).to(cuda)
        got = torch.ops.mar_torch.window_attention(qkv, bias, None, 3)
        want = torch.empty_like(got)
        _direct_launch("window_attention", wa._SIGNATURES["window_attention"],
                       f"window_attention_{suffix}",
                       (qkv.data_ptr(), bias.data_ptr(), None,
                        want.data_ptr(), None, 32, 196, 3, 32, 0,
                        ctypes.c_float(32 ** -0.5)), want)
        assert torch.equal(got, want)
    xr = torch.randn((8, 4, 28, 28, 96), generator=g).to(cuda)
    got = torch.ops.mar_torch.roll(xr, 0, 3, 3)
    want = torch.empty_like(got)
    _direct_launch("roll", rl._SIGNATURES, "roll_f32",
                   (xr.data_ptr(), want.data_ptr(), 8, 4, 28, 28, 96, 0, 3,
                    3, 1), want)
    assert torch.equal(got, want)
    assert dict(launch_counts) == {"framed_conv1d": 1, "window_attention": 1,
                                   "window_attention.bf16": 1, "roll": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_fakes_give_the_kernels_shape_and_dtype(cuda, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(41)
    real = {"qkv": torch.randn((16, 196, 192), generator=g).to(cuda, dtype),
            "bias": torch.randn((2, 196, 196), generator=g).to(cuda),
            "x": torch.randn((2, 4, 14, 14, 8), generator=g).to(cuda, dtype),
            "a": torch.randn((2, 8000), generator=g).to(cuda),
            "w": torch.randn((160, 64), generator=g).to(cuda),
            "b": torch.randn(64, generator=g).to(cuda)}
    want = [torch.ops.mar_torch.window_attention(real["qkv"], real["bias"],
                                                 None, 2),
            torch.ops.mar_torch.roll(real["x"], 0, 3, 3),
            torch.ops.mar_torch.framed_conv1d(real["a"], real["w"],
                                              real["b"], 160, 40, 80, None,
                                              None, False)]
    with FakeTensorMode() as mode:
        fake = {k: mode.from_tensor(v) for k, v in real.items()}
        got = [torch.ops.mar_torch.window_attention(fake["qkv"],
                                                    fake["bias"], None, 2),
               torch.ops.mar_torch.roll(fake["x"], 0, 3, 3),
               torch.ops.mar_torch.framed_conv1d(fake["a"], fake["w"],
                                                 fake["b"], 160, 40, 80,
                                                 None, None, False)]
    for f, r in zip(got, want):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 1536, 2), (3, 12, 5), (40, 768, 2304)])
def test_int8_mm_is_exact_on_the_card(cuda, m, k, n):
    """torch._int_mm takes M > 16 and K, N multiples of 8 on CUDA;
    int8_mm's zero padding keeps the int32 sums equal to the CPU's for the
    heads' N = 2 at 8 rows and ragged shapes."""
    from multimodalaggressionrecognition_tpu_torch.utils.quantize import (
        int8_mm)

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    got = int8_mm(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8_mm(a, w))
    assert torch.equal(got.cpu().long(), a.long() @ w.long().T)


@pytest.mark.cuda
def test_cpu_artifact_loads_on_the_card(cuda, tmp_path):
    """An artifact exported on the CPU and scored on the card: no node,
    weight or constant stays on the CPU, the ops launch their kernels, and
    the scores match the live CPU Predictor within 1e-3 of the largest
    logit."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ExportedPredictor, export_predictor)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    cfg = MultimodalConfig(hidden_size=64, fusion_heads=4,
                           audio_samples=16000, text_tokens=8)
    model = seeded_init_(build_model(cfg, ("audio", "text")), 0)
    pred = Predictor(model, batch_size=4, device="cpu", quantize="int8")
    example = {"audio": np.zeros((1, 16000), np.float32),
               "text": np.zeros((1, 8, 64), np.float32)}
    export_predictor(pred, example, str(tmp_path / "art"))
    exported = ExportedPredictor(str(tmp_path / "art"), device=cuda)
    program = exported.program
    assert not [n for n in program.graph.nodes
                if str(n.kwargs.get("device", "cuda")) == "cpu"]
    tensors = list(program.state_dict.values()) + list(
        program.constants.values())
    assert all(t.device.type == "cuda" for t in tensors
               if isinstance(t, torch.Tensor))
    rng = np.random.default_rng(42)
    req = {"audio": (rng.standard_normal((3, 16000)) * 0.1).astype(
               np.float32),
           "text": rng.standard_normal((3, 8, 64)).astype(np.float32)}
    launch_counts.clear()
    got = exported.predict(req, return_probs=False)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == 1
    want = pred.predict(req, return_probs=False)
    scale = max(np.abs(v).max() for v in want.values())
    for head in want:
        assert np.abs(got[head] - want[head]).max() <= 1e-3 * scale


# K2 in bf16 at the bf16 extraction's shapes (extract_features --backbone
# swin3d_t --compute_dtype bfloat16: N = 392 at 3, 6 and 12 heads, N = 128
# at 24), fewer windows; the shifted stages with a random mask
BF16_K2_EXTRACT_SHAPES = [(32, 392, 3, 32, 16), (16, 392, 6, 32, 4),
                          (8, 392, 12, 32, 0), (8, 128, 24, 32, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,heads,d,nw", BF16_K2_EXTRACT_SHAPES)
def test_window_attention_bf16_at_the_extraction_shapes(cuda, w, n, heads, d,
                                                        nw):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, cuda, seed=n + heads)
    q16, b16 = qkv.bfloat16(), bias.bfloat16()
    before = dict(launch_counts)
    got = fused_window_attention(q16, b16, mask, heads)
    torch.cuda.synchronize()
    assert launch_counts["window_attention.bf16"] == before.get(
        "window_attention.bf16", 0) + 1
    want = attention_core_reference(q16, b16, mask, heads)
    _bf16_close(got, want)
    _bf16_elementwise(got, want)


# the eight export_model entries at tests/test_torch_export.py's small
# widths (that file imports JAX, this one must not)
EXPORT_ENTRIES = [
    ("train_multimodal", ["--modalities", "audio,text", "--hidden_size", "64",
                          "--fusion_heads", "4", "--audio_samples", "16000",
                          "--text_tokens", "8"]),
    ("train_text_transformer", ["--num_layers", "1", "--text_tokens", "8",
                                "--hidden_size", "64", "--num_heads", "4"]),
    ("train_audio_rnn", ["--extractor", "cnn1d", "--audio_seconds", "1",
                         "--hidden_size", "32"]),
    ("train_audio_transformer", ["--arch", "transformer", "--audio_seconds",
                                 "1"]),
    ("train_video_transformer", ["--video_frames", "8", "--video_size", "32",
                                 "--video_window", "4", "--num_layers", "1"]),
    ("train_video_rnn", ["--feature_dim", "32", "--hidden_size", "32",
                         "--sequence_len", "5"]),
    ("train_audio_text", ["--audio_samples", "16000", "--text_tokens", "8",
                          "--hidden_size", "64"]),
    ("train3dcnn", ["--frame_num", "8", "--video_size", "32"]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,flags", EXPORT_ENTRIES,
                         ids=[e[0] for e in EXPORT_ENTRIES])
def test_export_entry_families_bf16_on_the_card(cuda, entry, flags,
                                                tmp_path):
    """export_model --compute_dtype bfloat16 on the card, for each --entry:
    the artifact scores on the card within 1e-6 of the same seeded model's
    live bf16 Predictor there, f32 and finite, and its forward launches
    the same kernels, by dtype, as the live one."""
    import importlib

    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.cli import export_model
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        parse_config)
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ExportedPredictor)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    out = str(tmp_path / "art")
    export_model.main(["--entry", entry, "--allow_random_weights", "true",
                       *flags, "--compute_dtype", "bfloat16", "--batch_size",
                       "2", "--device", str(cuda), "--output_dir", out])
    mod = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{entry}")
    cfg = parse_config(export_model._entry_config_cls(mod),
                       flags + ["--batch_size", "2", "--device", str(cuda)])
    model, spec = export_model._build_model_and_spec(mod, cfg)
    live = Predictor(seeded_init_(model, cfg.seed), batch_size=2,
                     device=cuda, compute_dtype="bfloat16")
    exported = ExportedPredictor(out, device=cuda)
    rng = np.random.default_rng(5)
    request = {m: rng.standard_normal((2, *s)).astype(np.float32) * 0.3
               for m, s in spec.items()}
    counts = {}
    for key, pred in (("live", live), ("exported", exported)):
        pred.predict(request)
        torch.cuda.synchronize()
        launch_counts.clear()
        got = pred.predict(request, return_probs=False)
        torch.cuda.synchronize()
        counts[key] = dict(launch_counts)
        if key == "live":
            want = got
    assert counts["exported"] == counts["live"]
    assert sorted(got) == sorted(want)
    for head in want:
        assert got[head].dtype == np.float32
        assert np.isfinite(got[head]).all()
        np.testing.assert_allclose(got[head], want[head], atol=1e-6)


@pytest.mark.cuda
def test_native_wav_loader_builds_and_decodes_on_the_card_host(cuda, tmp_path):
    """libmarhost built from native/marhost.cpp on the card's host: 5 s
    wavs at 44.1 kHz through wav_read and wav_batch (1 and 4 threads)
    within 2e-3 of the numpy loader (tests/test_native.py:40)."""
    import numpy as np
    from scipy.io import wavfile

    from multimodalaggressionrecognition_tpu_torch.data import native
    from multimodalaggressionrecognition_tpu_torch.data.files import _load_wav

    assert native.available(), native.unavailable_reasons()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"clip{i}.wav"))
        wavfile.write(paths[-1], 44100, (rng.standard_normal(5 * 44100)
                                         * 3000).astype(np.int16))
    want = np.stack([_load_wav(p, 16000) for p in paths])
    assert want.shape == (4, 80000)
    got = np.stack([native.wav_read(p, 80000) for p in paths])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    for threads in (1, 4):
        np.testing.assert_array_equal(
            native.wav_batch(paths, 80000, num_threads=threads), got)


def _pieces_model(kind, cfg):
    """The tri-modal towers (full width) under the pieces no CLI builds,
    seeded, LayerNorms randomized (at their init the Swin's tokens sum to
    ~1e-6 and rounding decides the fusion's zero-row mask)."""
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        build_model)
    from multimodalaggressionrecognition_tpu_torch.models import (
        audiotext, fusion, heads, physverb)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)

    modalities = ("audio", "text", "video")
    base = build_model(cfg, modalities)
    kw = dict(extractors=dict(base.extractors),
              feature_shapes=base.feature_shapes, modalities=base.modalities)
    if kind == "cross":
        model = audiotext.MultimodalModel(
            classifiers={m: heads.OutputClassifier(2, input_size=768)
                         for m in modalities},
            fusion=fusion.CrossAttentionFusion(768, 8), **kw)
    else:
        model = physverb.PhysVerbModel(
            classifier=physverb.PhysVerbClassifierAddFeatures(
                2, {m: (768, 256) for m in modalities}),
            fusion=fusion.AveragedFeaturesTransformerFusion(1, 768, 8), **kw)
    seeded_init_(model, 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.add_(0.05 * torch.randn(m.bias.shape, generator=g))
    return model


def _trimodal_batch(n, frames, seed=2):
    g = torch.Generator().manual_seed(seed)
    data = {"audio": torch.randn((n, 80000), generator=g) * 0.1,
            "text": torch.randn((n, 48, 768), generator=g),
            "video": torch.randn((n, frames, 112, 112, 3), generator=g)}
    return {m: {"data": d, "present": torch.ones(n)} for m, d in data.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cross", "averaged"])
def test_pieces_models_on_the_card_match_the_cpu(cuda, kind):
    """chip_smoke's pieces models at full width, b2 with 16 frames: the
    eval forward launches K1 1, K2 12, K4 4 and its logits are within
    1e-3 of the CPU's largest."""
    import copy

    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig)

    cpu = _pieces_model(kind, MultimodalConfig(video_frames=16)).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    batch = _trimodal_batch(2, 16)
    with torch.inference_mode():
        want = cpu(batch)
        launch_counts.clear()
        got = gpu({m: {k: v.to(cuda) for k, v in d.items()}
                   for m, d in batch.items()})
        torch.cuda.synchronize()
    assert dict(launch_counts) == {"framed_conv1d": 1, "window_attention": 12,
                                   "roll": 4}
    assert list(got) == gpu.head_names()
    scale = max(w.abs().max().item() for w in want.values())
    for h, w in want.items():
        assert got[h].shape == (2, 2)
        assert (got[h].cpu() - w).abs().max().item() <= 1e-3 * scale, h


@pytest.mark.cuda
def test_remat_dots_step_matches_save_nothing_on_the_card(cuda):
    """One train-mode step of the unfrozen tri-modal model (full width, b2,
    16 frames) under remat "dots" and save-nothing from the same weights
    and generator: K1 1, K2 24, K3 12, K4 12 launches each; the loss and
    every gradient within 1e-6 of save-nothing's (of each tensor's
    largest, plus two save-nothing runs' spread)."""
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, head_losses_and_metrics)

    model = seeded_init_(build_model(
        MultimodalConfig(video_frames=16, video_freeze=False),
        ("audio", "text", "video")), 0).to(cuda).train()
    swin = model.extractors["video"].backbone.backbone
    n = 2
    batch = {"modalities": {m: {k: v.to(cuda) for k, v in d.items()}
                            for m, d in _trimodal_batch(n, 16).items()},
             "labels": {h: torch.tensor([0, 1], device=cuda)
                        for h in ("phys", "verb")},
             "label_mask": {h: torch.ones(n, device=cuda)
                            for h in ("phys", "verb")},
             "sample_mask": torch.ones(n, device=cuda)}
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    losses, grads = {}, {}
    torch.backends.cudnn.deterministic = True  # the CNN1D's conv backward
    try:
        for run in ("dots", "none", "none_again"):
            swin.remat_policy = run.split("_")[0]
            set_generator(model, torch.Generator(cuda).manual_seed(3))
            model.zero_grad(set_to_none=True)
            launch_counts.clear()
            total, _ = head_losses_and_metrics(model(batch["modalities"]),
                                               batch, specs, 2)
            total.backward()
            torch.cuda.synchronize()
            assert dict(launch_counts) == {
                "framed_conv1d": 1, "window_attention": 24,
                "window_attention_bwd": 12, "roll": 12}, run
            losses[run] = total.item()
            grads[run] = {k: p.grad.clone()
                          for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    assert abs(losses["dots"] - losses["none"]) <= 1e-6 * abs(losses["none"])
    for name, want in grads["none"].items():
        # the spread of two save-nothing runs, should an op still differ
        spread = (grads["none_again"][name] - want).abs().max().item()
        err = (grads["dots"][name] - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item() + spread, name


def _flagship_step(device, mesh):
    """Loss and gradients of one train step of the hidden-64 flagship on
    `device` (dropout on, one generator seed), on `mesh` or plain."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
        _batch, _flagship)
    from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
        _tree_map)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    state = create_train_state(_flagship(), OptimizerConfig(1e-3), device,
                               mesh=mesh)
    set_generator(state.model, torch.Generator(device).manual_seed(0))
    batch = _tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device),
                      _batch(8))
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    metrics = train_step(state, batch, specs, 2)
    return float(metrics["total_loss"]), {
        n: p.grad.detach().clone() for n, p in state.model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_train_step_never_blocks_the_host(cuda, compute_dtype):
    """Steps 2-4 of the hidden-64 flagship's train step, a focal head with
    alpha and a weighted-CE head, raise nothing under CUDA's sync debug
    mode "error": no copy from the host, readback or synchronisation in
    the step.  The first step builds the loss's class-weight tables (one
    copy each); the later ones only hit them."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
        _tree_map)
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.ops.losses import (
        TABLE_COUNTS)
    from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
        _batch, _flagship)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    state = create_train_state(_flagship(), OptimizerConfig(1e-3), cuda)
    set_generator(state.model, torch.Generator(cuda).manual_seed(0))
    host = _batch(8)
    host["labels"]["phys"] = (np.arange(8) // 2 % 2).astype(np.int64)
    host["label_mask"]["phys"] = np.ones((8,), np.float32)
    batch = _tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(cuda),
                      host)
    specs = {"phys": LossSpec("focal", class_weights=(0.3, 0.7)),
             "verb": LossSpec("weighted_ce", class_weights=(0.6, 0.4))}
    train_step(state, batch, specs, 2, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    before = dict(TABLE_COUNTS)
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            metrics = train_step(state, batch, specs, 2,
                                 compute_dtype=compute_dtype)
            losses.append(metrics["total_loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TABLE_COUNTS["builds"] == before["builds"]
    assert TABLE_COUNTS["hits"] == before["hits"] + 6
    assert all(bool(torch.isfinite(x)) for x in losses)


@pytest.mark.cuda
def test_xlsr_bf16_train_step_never_blocks_the_host(cuda):
    """Steps 2-4 of the audio,text model's bf16 train step with a two-layer
    XLS-R tower at its published widths (1 s clips: the frozen conv
    encoder with K1 on conv0, time masking, the weight-normed positional
    conv, dropout) raise nothing under CUDA's sync debug mode "error": the
    time mask's spans are drawn and applied on the card, each layer's
    attention runs the self-attention kernel pair, and the frozen
    encoder's leaves get no gradient."""
    import dataclasses

    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import (
        XLSR_300M)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    cfg = MultimodalConfig(audio_extractor="xlsr_300m", audio_samples=16000,
                           text_tokens=8)
    model = seeded_init_(build_model(
        cfg, ("audio", "text"),
        audio_config=dataclasses.replace(XLSR_300M, num_layers=2)), 0)
    state = create_train_state(model, OptimizerConfig(3e-4), cuda)
    set_generator(state.model, torch.Generator(cuda).manual_seed(0))
    g = torch.Generator(cuda).manual_seed(1)
    ones = torch.ones(4, device=cuda)
    batch = {"modalities": {
        "audio": {"data": torch.randn(4, 16000, generator=g, device=cuda)
                  * 0.1, "present": ones},
        "text": {"data": torch.randn(4, 8, 768, generator=g, device=cuda),
                 "present": ones}},
        "labels": {"verb": torch.arange(4, device=cuda) % 2},
        "label_mask": {"verb": ones}, "sample_mask": ones}
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    train_step(state, batch, specs, 2, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    launches = launch_counts["framed_conv1d"]
    attention = dict(launch_counts)
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            losses.append(train_step(state, batch, specs, 2,
                                     compute_dtype="bfloat16")["total_loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts["framed_conv1d"] == launches + 3
    for key in ("self_attention.bf16", "self_attention_bwd.bf16"):
        assert launch_counts[key] == attention.get(key, 0) + 2 * 3, key
    assert all(bool(torch.isfinite(x)) for x in losses)
    frozen = state.model.extractors["audio"].encoder.feature_extractor
    assert all(p.grad is None for p in frozen.parameters())


@pytest.mark.cuda
def test_one_rank_nccl_step_matches_plain(cuda):
    """A world of one over NCCL: the data-parallel step (its loss and
    gradient all-reduces) equals the plain step, both under deterministic
    algorithms: loss rtol 1e-5, each gradient within 1e-4 of its largest
    (a conv bias feeding a train-mode BatchNorm, whose gradient is 0 in
    exact arithmetic, within 1e-4 of its conv weight's largest)."""
    import re

    import torch.distributed as dist

    from multimodalaggressionrecognition_tpu_torch.parallel.mesh import (
        init_from_env, local_device, make_mesh)

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    device = local_device(cuda)
    init_from_env(device)
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_mesh(1, device)
        loss, grads = _flagship_step(device, mesh)
        want_loss, want = _flagship_step(device, None)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(before[0])
        cudnn.deterministic, cudnn.benchmark = before[1:]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, g in want.items():
        fed = re.fullmatch(r"(.*\.conv\d+)\.bias", name)
        scale = want[f"{fed[1]}.weight" if fed else name].abs().max().item()
        assert (grads[name] - g).abs().max().item() <= 1e-4 * scale + 1e-12, (
            name)


@pytest.mark.cuda
def test_predictor_replicas_on_one_card(cuda):
    """Predictor(devices=["cuda:0", "cuda:0"]): two replicas, each on half
    of the b8 batch, within 1e-5 of one device; K1 once per replica."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
        AUDIO_LEN, HIDDEN, TEXT_LEN, _flagship)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    rng = np.random.default_rng(0)
    clips = {"audio": (rng.standard_normal((8, AUDIO_LEN)) * 0.1).astype(
                 np.float32),
             "text": rng.standard_normal((8, TEXT_LEN, HIDDEN)).astype(
                 np.float32)}
    one = Predictor(_flagship(), batch_size=8, device="cuda")
    two = Predictor(_flagship(), batch_size=8, devices=["cuda:0", "cuda:0"])
    want = one.predict(clips)
    before = launch_counts["framed_conv1d"]
    got = two.predict(clips)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == before + 2
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_devices", [2, 4])
def test_predictor_tensor_parallel_on_one_card(cuda, n_devices):
    """Predictor(devices=["cuda:0"] * n, model_parallelism=2): tp 2 and
    dp 2 x tp 2 with the fusion layer split, within 1e-5 of one device; K1
    once per data group."""
    import numpy as np

    from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
        AUDIO_LEN, HIDDEN, TEXT_LEN, _flagship)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        local_splits)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    rng = np.random.default_rng(1)
    clips = {"audio": (rng.standard_normal((6, AUDIO_LEN)) * 0.1).astype(
                 np.float32),
             "text": rng.standard_normal((6, TEXT_LEN, HIDDEN)).astype(
                 np.float32)}
    one = Predictor(_flagship(), batch_size=8, device="cuda")
    tp = Predictor(_flagship(), batch_size=8, devices=["cuda:0"] * n_devices,
                   model_parallelism=2)
    assert len(local_splits(tp.model)) == 6
    want = one.predict(clips)
    before = launch_counts["framed_conv1d"]
    got = tp.predict(clips)
    torch.cuda.synchronize()
    assert launch_counts["framed_conv1d"] == before + n_devices // 2
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-5)


# the self-attention kernels (ops/cuda/self_attention.py): XLS-R's layer at
# B = 2 (16 heads, 499 frames of a 10 s clip, d = 64), ragged and single
# tiles, head dim 32, and one key
SELF_ATTENTION_SHAPES = [(2, 16, 499, 64), (1, 2, 37, 64), (2, 3, 64, 64),
                         (1, 2, 65, 32), (2, 4, 130, 32), (1, 1, 1, 64)]


def _self_attention_inputs(cuda, b, heads, t, d, seed=0):
    """bf16 qkv, the f32 uniforms and a bf16 output gradient."""
    g = torch.Generator(cuda).manual_seed(seed)
    qkv = (torch.randn(b, t, 3 * heads * d, generator=g, device=cuda)
           * 0.5).bfloat16()
    u = torch.rand((b, heads, t, t), generator=g, device=cuda)
    cot = torch.randn(b, t, heads * d, generator=g, device=cuda).bfloat16()
    return qkv, u, cot


def _unpack_keep_bits(bits, t):
    """(B, heads, T, words) int32 -> (B, heads, T, 32 words) bool, key j at
    bit j % 32 of word j // 32."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[..., None] >> shifts) & 1).flatten(-2).bool()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("b,heads,t,d", SELF_ATTENTION_SHAPES)
def test_self_attention_kernels_match_plain_in_f32(cuda, b, heads, t, d,
                                                   rate):
    """The forward and dqkv (both kernels, the dS pieces in the products)
    within one bf16 ulp + 3e-5 of the plain version in f32 on the same
    uniforms, one launch each; without a gradient the same forward bit for
    bit (no dropout: the `mar_torch::self_attention` op)."""
    from multimodalaggressionrecognition_tpu_torch.ops.cuda.self_attention import (
        self_attention, self_attention_reference)

    qkv, u, cot = _self_attention_inputs(cuda, b, heads, t, d)
    keep, u = 1.0 - rate, (u if rate else None)
    x = qkv.clone().requires_grad_(True)
    before = dict(launch_counts)
    out = self_attention(x, u, heads, keep)
    out.backward(cot)
    torch.cuda.synchronize()
    assert launch_counts["self_attention.bf16"] == before.get(
        "self_attention.bf16", 0) + 1
    assert launch_counts["self_attention_bwd.bf16"] == before.get(
        "self_attention_bwd.bf16", 0) + 1
    xf = qkv.float().requires_grad_(True)
    want = self_attention_reference(xf, u, heads, keep)
    want.backward(cot.float())
    _bf16_elementwise(out.detach(), want.detach().bfloat16())
    _bf16_elementwise(x.grad, xf.grad.bfloat16())
    with torch.no_grad():
        again = self_attention(qkv, u, heads, keep)
    assert torch.equal(again.view(torch.int16), out.detach().view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,t,d", SELF_ATTENTION_SHAPES[:3])
def test_self_attention_keep_bits_are_u_below_keep(cuda, b, heads, t, d):
    """The forward's bit-packed mask is `u < keep` (the plain dropout's f32
    comparison) bit for bit, with 0 past T; lse is finite."""
    from multimodalaggressionrecognition_tpu_torch.ops.cuda.self_attention import (
        _launch_fwd)

    qkv, u, _ = _self_attention_inputs(cuda, b, heads, t, d, seed=3)
    for keep in (0.9, 1.0 - 0.1, 0.5):
        _, lse, bits = _launch_fwd(qkv, u, heads, keep, for_grad=True)
        kept = _unpack_keep_bits(bits, t)
        assert torch.equal(kept[..., :t], u < keep)
        assert not kept[..., t:].any()
        assert bool(torch.isfinite(lse).all())


@pytest.mark.cuda
def test_self_attention_kernels_are_deterministic(cuda):
    """Two launches of each kernel at XLS-R's shape agree bit for bit."""
    from multimodalaggressionrecognition_tpu_torch.ops.cuda.self_attention import (
        _launch_fwd, self_attention_bwd)

    b, heads, t, d = SELF_ATTENTION_SHAPES[0]
    qkv, u, cot = _self_attention_inputs(cuda, b, heads, t, d, seed=4)
    first = _launch_fwd(qkv, u, heads, 0.9, for_grad=True)
    again = _launch_fwd(qkv, u, heads, 0.9, for_grad=True)
    dq1 = self_attention_bwd(qkv, cot, first[1], first[2], heads, 0.9)
    dq2 = self_attention_bwd(qkv, cot, first[1], first[2], heads, 0.9)
    torch.cuda.synchronize()
    for x, y in zip(first + (dq1,), again + (dq2,)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.cuda
def test_xlsr_train_step_launches_the_self_attention_kernels(cuda):
    """One bf16 train step of the audio,text model with the published
    24-layer XLS-R tower (b2, 1 s clips) launches the forward and the
    backward kernel once a layer, 24 each; the fusion layer, masked, takes
    the composition."""
    from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
        MultimodalConfig, build_model)
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import (
        XLSR_300M)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    cfg = MultimodalConfig(audio_extractor="xlsr_300m", audio_samples=16000,
                           text_tokens=8)
    assert XLSR_300M.num_layers == 24
    model = seeded_init_(build_model(cfg, ("audio", "text"),
                                     audio_config=XLSR_300M), 0)
    state = create_train_state(model, OptimizerConfig(3e-4), cuda)
    set_generator(state.model, torch.Generator(cuda).manual_seed(0))
    g = torch.Generator(cuda).manual_seed(1)
    ones = torch.ones(2, device=cuda)
    batch = {"modalities": {
        "audio": {"data": torch.randn(2, 16000, generator=g, device=cuda)
                  * 0.1, "present": ones},
        "text": {"data": torch.randn(2, 8, 768, generator=g, device=cuda),
                 "present": ones}},
        "labels": {"verb": torch.arange(2, device=cuda) % 2},
        "label_mask": {"verb": ones}, "sample_mask": ones}
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    before = dict(launch_counts)
    loss = train_step(state, batch, specs, 2,
                      compute_dtype="bfloat16")["total_loss"]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    for key in ("self_attention.bf16", "self_attention_bwd.bf16"):
        assert launch_counts[key] - before.get(key, 0) == 24, key
