"""The port's CUDA kernels against their plain versions, on a CUDA card.

Imports no JAX, so it runs on a GPU machine without it; tests/conftest.py
does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips.  Tolerance atol/rtol 1e-4: both sides are
f32 (TF32 off) and only the summation order differs; the window-attention
kernel at tests/test_pallas.py's small shapes is held to 1e-5, as there.
"""

import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    _attention_mask)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, fused_window_attention)
from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
    launch_counts)

# (B, L, F, hop, pad, C): tests/test_pallas.py's shapes, a non-multiple
# F/hop with a ragged C tile, and a batch past one T tile per row
SHAPES = [(2, 8000, 160, 40, 80, 64), (2, 8000, 512, 256, 0, 128),
          (2, 8000, 10, 5, 0, 512), (2, 8000, 147, 40, 3, 24),
          (3, 1000, 7, 3, 0, 70), (1, 160, 160, 40, 80, 64)]


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
