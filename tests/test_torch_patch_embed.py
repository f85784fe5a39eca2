"""The Swin's patch embedding as one patch GEMM (models/swin3d.PatchEmbed3d)
against the conv it replaces, `F.conv3d` with stride = kernel and no
padding on the channels-last clip.

- f32: the output, dW, db and dX within 1e-5 of the conv's largest value;
  bf16 against the conv in bf16 within 1e-2 of the largest (the tolerance
  the Swin's bf16 kernel tests hold K2 and K3's plain versions to);
- sizes that (2, 4, 4) does not divide: the trailing frames and pixels
  dropped, as the conv's floor drops them, and zero gradient there;
- the parameters of nn3d.Conv3d: names, shapes, the same values from the
  same global seed and from `seeded_init_`;
- the backward keeps the input (no copy) and the weight, never the patch
  matrix: no saved tensor is larger than the input;
- `calls` rises once a forward, on the Swin's forward too; without a
  gradient the forward builds no autograd node.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.nn3d import Conv3d
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    PatchEmbed3d, SwinTransformer3d)

KERNEL = (2, 4, 4)
SHAPES = [(2, 8, 16, 16, 3), (1, 5, 18, 13, 3), (3, 3, 7, 9, 3)]


def _conv_reference(embed, x, dtype):
    """F.conv3d on a copy of embed's parameters; x (B, T, H, W, C)."""
    conv = Conv3d(x.shape[-1], embed.weight.shape[0], KERNEL, stride=KERNEL)
    conv.load_state_dict(embed.state_dict())
    return conv, conv(x.to(dtype))


def _largest_gap(got, want):
    want = want.detach().float()
    return ((got.detach().float() - want).abs().max()
            / want.abs().max()).item()


def _compare(shape, dtype, tol, seed=0):
    torch.manual_seed(seed)
    embed = PatchEmbed3d(shape[-1], 96, KERNEL)
    x = torch.randn(shape)
    xa = x.to(dtype).requires_grad_(True)
    xb = x.to(dtype).requires_grad_(True)
    got = embed(xa)
    conv, want = _conv_reference(embed, xb, dtype)
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    assert got.is_contiguous()
    g = torch.randn(got.shape).to(dtype)
    got.backward(g)
    want.backward(g)
    for name, a, b in (("out", got, want), ("dW", embed.weight.grad,
                                              conv.weight.grad),
                       ("db", embed.bias.grad, conv.bias.grad),
                       ("dX", xa.grad, xb.grad)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _largest_gap(a, b) <= tol, name
    return xa


@pytest.mark.parametrize("shape", SHAPES)
def test_patch_gemm_matches_conv3d_in_f32(shape):
    _compare(shape, torch.float32, 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_patch_gemm_matches_conv3d_in_bf16(shape):
    _compare(shape, torch.bfloat16, 1e-2)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_patch_gemm_drops_what_the_kernel_does_not_cover(shape):
    """Frames and pixels past the last whole patch take no part: the
    output has the conv's floor of sizes and their gradient is zero."""
    xa = _compare(shape, torch.float32, 1e-5, seed=1)
    _, t, h, w, _ = shape
    kt, kh, kw = KERNEL
    assert t % kt or h % kh or w % kw
    for tail in (xa.grad[:, t // kt * kt:], xa.grad[:, :, h // kh * kh:],
                 xa.grad[:, :, :, w // kw * kw:]):
        assert not tail.any()


def test_parameters_are_the_convs():
    """Names, shapes and values from the same seed as nn3d.Conv3d, both
    from the global generator and from `seeded_init_`."""
    torch.manual_seed(7)
    conv = Conv3d(3, 96, KERNEL, stride=KERNEL)
    torch.manual_seed(7)
    embed = PatchEmbed3d(3, 96, KERNEL)
    a, b = conv.state_dict(), embed.state_dict()
    assert list(a) == list(b) == ["weight", "bias"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    seeded = [seeded_init_(nn.ModuleDict({"patch_embed": m, "head": nn.Linear(
        4, 2)}), seed=3).state_dict() for m in (conv, embed)]
    assert list(seeded[0]) == list(seeded[1])
    for k in seeded[0]:
        assert torch.equal(seeded[0][k], seeded[1][k]), k
    swin = SwinTransformer3d(depths=(1,), num_heads=(3,))
    assert isinstance(swin.patch_embed, PatchEmbed3d)
    shapes = {k: tuple(v.shape) for k, v in swin.state_dict().items()
              if k.startswith("patch_embed.")}
    assert shapes == {"patch_embed.weight": (96, 3, 2, 4, 4),
                      "patch_embed.bias": (96,)}


@pytest.mark.parametrize("x_grad", [False, True])
def test_backward_keeps_no_patch_matrix(x_grad):
    """Every tensor saved for the backward is at most the input's size, and
    the input is kept as it is, not copied."""
    embed = PatchEmbed3d(3, 96, KERNEL)
    # a clip that the kernel tiles, so that the patch matrix has the
    # input's size exactly and a copy of it would be caught by the pointer
    x = torch.randn(2, 8, 16, 16, 3, requires_grad=x_grad)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = embed(x)
    assert saved
    for t in saved:
        assert t.numel() <= x.numel()
        if t.numel() == x.numel():
            assert t.data_ptr() == x.data_ptr()
    y.sum().backward()
    assert embed.weight.grad is not None
    assert (x.grad is not None) == x_grad


def test_calls_count_each_forward_and_no_grad_builds_no_node():
    embed = PatchEmbed3d(3, 96, KERNEL)
    x = torch.randn(1, 4, 8, 8, 3)
    y = embed(x)
    assert embed.calls == 1 and y.grad_fn is not None
    with torch.no_grad():
        y0 = embed(x)
    assert embed.calls == 2 and y0.grad_fn is None
    embed.requires_grad_(False)
    assert embed(x).grad_fn is None and embed.calls == 3
    torch.testing.assert_close(y0, y.detach(), rtol=0, atol=0)
    swin = SwinTransformer3d(depths=(1,), num_heads=(3,))
    with torch.inference_mode():
        swin.eval()(torch.randn(1, 4, 16, 16, 3))
    assert swin.patch_embed.calls == 1
