"""Port fused window attention (ops/cuda/window_attention.py) against JAX.

On the CPU the port's wrapper takes its plain version; the JAX side runs
`fused_window_attention` in Pallas interpret mode (as tests/test_pallas.py
does off the TPU) and its plain `attention_core_ref`.  Shapes: those of
tests/test_pallas.py (head dims 8, 32, 16; masked and unmasked) plus one
masked window of Swin3D-T's clamped N=196.  Tolerance atol 1e-5, as in
tests/test_pallas.py.  The CUDA kernel itself is held to the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops.pallas.window_attention import (
    attention_core_ref, fused_window_attention as jax_fused_window_attention)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, fused_window_attention)
from multimodalaggressionrecognition_tpu_torch.utils.kernels import (
    launch_counts)

# (W, N, heads, d, nW_img); nW_img 0 = no mask
SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0),
          (4, 196, 3, 32, 2)]


def inputs(w, n, heads, d, nw, seed=0):
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((w, n, 3 * c)).astype(np.float32)
    bias = (rng.standard_normal((heads, n, n)) * 0.1).astype(np.float32)
    mask = (np.where(rng.uniform(0, 1, (nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if nw else None)
    return qkv, bias, mask


def _port(qkv, bias, mask, heads):
    with torch.inference_mode():
        return fused_window_attention(
            torch.from_numpy(qkv), torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask), heads).numpy()


@pytest.mark.parametrize("w,n,heads,d,nw", SHAPES)
def test_plain_matches_jax_kernel_and_reference(w, n, heads, d, nw):
    qkv, bias, mask = inputs(w, n, heads, d, nw, seed=n)
    jargs = (jnp.asarray(qkv), jnp.asarray(bias),
             None if mask is None else jnp.asarray(mask))
    got = _port(qkv, bias, mask, heads)
    assert got.shape == (w, n, heads * d)
    np.testing.assert_allclose(
        got, np.asarray(jax_fused_window_attention(*jargs, heads)), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(attention_core_ref(*jargs, heads)), atol=1e-5)


def test_mask_is_taken_per_window_modulo_nw():
    """Window w uses mask[w % nW_img]: a mask that blocks all but one key
    per window makes each window's output that key's value row."""
    w, n, heads, d, nw = 6, 5, 1, 8, 3
    qkv, bias, _ = inputs(w, n, heads, d, 0, seed=1)
    mask = np.full((nw, n, n), -100.0, np.float32)
    for k in range(nw):
        mask[k, :, k] = 0.0
    got = _port(qkv, bias, mask, heads)
    v = qkv[..., 2 * heads * d:]
    for win in range(w):
        key = win % nw
        np.testing.assert_allclose(got[win], np.repeat(v[win, key:key + 1], n,
                                                       axis=0), atol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    qkv, bias, mask = inputs(4, 24, 3, 8, 2, seed=2)
    before = launch_counts["window_attention"]
    got = _port(qkv, bias, mask, 3)
    ref = attention_core_reference(torch.from_numpy(qkv),
                                   torch.from_numpy(bias),
                                   torch.from_numpy(mask), 3).numpy()
    np.testing.assert_array_equal(got, ref)
    assert launch_counts["window_attention"] == before


def test_other_devices_raise():
    qkv = torch.zeros((2, 4, 24), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_window_attention(qkv, torch.zeros((1, 4, 4), device="meta"),
                               None, 1)
