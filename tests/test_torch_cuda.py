"""The port's CUDA kernels against their plain versions, on a CUDA card.

Imports no JAX, so it runs on a GPU machine without it; tests/conftest.py
does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips.  Tolerance atol/rtol 1e-4: both sides are
f32 (TF32 off) and only the summation order differs.
"""

import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference)
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
