"""The port's spectrogram, masks and resampling (ops/stft.py, ops/resample.py)
against the JAX package's, on the same seeded numpy inputs.

- spectrogram: against JAX `spectrogram` on its XLA route and on its Pallas
  route (interpret mode on the CPU), atol 1e-2 / rtol 1e-4 as
  tests/test_pallas.py holds the two JAX routes; against torch.stft, atol
  2e-2 / rtol 1e-4 as tests/test_ops.py holds the JAX one.  The port's CPU
  path is the framed-conv kernel's plain version.
- masks: a jax.random stream cannot be drawn in torch, so the apply step is
  given JAX's own (width, start) and must give JAX's output bit for bit;
  the port's draw is held to its properties (one mask shared by the batch,
  width < mask_param, the zeroed band inside the axis, reproducible from a
  seeded generator).
- resampling: `resample_poly_np` and the device `resample_poly` against
  JAX's at 1e-4, against a brute-force sum of the same windowed sinc, and on
  a 1 kHz tone (tests/test_ops.py, tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.ops import resample as jres
from multimodalaggressionrecognition_tpu.ops import stft as jstft
from multimodalaggressionrecognition_tpu_torch.cli.train_audio_transformer import (
    SpectrogramMasks)
from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    set_generator)
from multimodalaggressionrecognition_tpu_torch.ops import resample, stft


def _signal(seed, b=2, length=8000):
    return np.random.default_rng(seed).standard_normal(
        (b, length)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n_fft", [512, 256])
def test_spectrogram_matches_jax(n_fft, use_pallas):
    x = _signal(n_fft)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft=n_fft,
                                        use_pallas=use_pallas))
    got = stft.spectrogram(torch.from_numpy(x), n_fft=n_fft).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1,
                                       8000 // (n_fft // 2) + 1)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("n_fft", [512, 256])
def test_spectrogram_matches_torch_stft(n_fft):
    x = torch.from_numpy(_signal(n_fft + 1))
    want = torch.stft(x, n_fft, hop_length=n_fft // 2, win_length=n_fft,
                      window=torch.hann_window(n_fft, periodic=True),
                      center=True, pad_mode="reflect", onesided=True,
                      return_complex=True).abs().pow(2)
    got = stft.spectrogram(x, n_fft=n_fft)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2,
                               rtol=1e-4)


def test_spectrogram_power_and_lead_axes_match_jax():
    """power != 2 (a magnitude spectrogram) and leading axes (3, 2, L)."""
    x = _signal(3, b=6, length=4000).reshape(3, 2, 4000)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft=256, power=1.0,
                                        use_pallas=False))
    got = stft.spectrogram(torch.from_numpy(x), n_fft=256, power=1.0)
    assert got.shape == want.shape == (3, 2, 129, 4000 // 128 + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)


def _jax_draw(key, size, mask_param):
    """JAX `_axis_mask`'s own draw: (width, start)."""
    k1, k2 = jax.random.split(key)
    width = jax.random.uniform(k1, (), minval=0.0, maxval=float(mask_param))
    start = jax.random.uniform(k2, (), minval=0.0, maxval=float(size) - width)
    return float(width), float(start)


@pytest.mark.parametrize("axis_name", ["freq", "time"])
@pytest.mark.parametrize("seed", [0, 7])
def test_mask_apply_equals_jax_given_its_draw(axis_name, seed):
    spec = np.random.default_rng(seed).standard_normal(
        (2, 257, 313)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    axis = 1 if axis_name == "freq" else 2
    fn = jstft.freq_mask if axis_name == "freq" else jstft.time_mask
    want = np.asarray(fn(key, jnp.asarray(spec), 80))
    width, start = _jax_draw(key, spec.shape[axis], 80)
    got = stft.apply_axis_mask(torch.from_numpy(spec),
                               torch.tensor(width, dtype=torch.float32),
                               torch.tensor(start, dtype=torch.float32), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def _zeroed(masked, axis):
    """(B, size): which indices along `axis` each batch row has zeroed."""
    other = tuple(a for a in range(masked.dim()) if a not in (0, axis))
    return (masked == 0).all(dim=other)


@pytest.mark.parametrize("axis_name,param", [("freq", 80), ("time", 80),
                                             ("freq", 16)])
def test_mask_draw_properties(axis_name, param):
    spec = torch.rand((3, 129, 63)) + 1.0  # no zero of its own
    fn = stft.freq_mask if axis_name == "freq" else stft.time_mask
    axis = 1 if axis_name == "freq" else 2
    size = spec.shape[axis]
    widths = []
    for seed in range(20):
        g = torch.Generator().manual_seed(seed)
        out = fn(spec, param, g)
        again = fn(spec, param, torch.Generator().manual_seed(seed))
        assert torch.equal(out, again)  # reproducible from the seed
        rows = _zeroed(out, axis)
        assert (rows == rows[0]).all()  # one mask shared by the batch
        band = torch.nonzero(rows[0]).flatten()
        if band.numel():
            assert band.max() - band.min() + 1 == band.numel()  # contiguous
            assert 0 <= band.min() and band.max() < size
        # untouched outside the band
        keep = ~rows[0]
        idx = [slice(None)] * 3
        idx[axis] = keep
        assert torch.equal(out[tuple(idx)], spec[tuple(idx)])
        assert band.numel() <= param  # width < mask_param
        widths.append(band.numel())
        # the draw: width ~ U[0, param), start ~ U[0, size - width) (as in
        # JAX, between size - width and 0 where the width passes the axis)
        w, s = stft.draw_axis_mask(size, param,
                                   torch.Generator().manual_seed(seed))
        assert 0 <= w < param and s * (s - (size - w)) <= 0
    assert max(widths) > 0 and len(set(widths)) > 3


def test_mask_module_draws_from_the_trainers_generator():
    spec = torch.rand((2, 129, 63)) + 1.0
    masks = SpectrogramMasks(40, 20)
    assert torch.equal(masks.eval()(spec), spec)  # identity in eval mode
    masks.train()
    outs = []
    for _ in range(2):
        set_generator(masks, torch.Generator().manual_seed(4))
        outs.append(masks(spec))
    assert torch.equal(*outs) and not torch.equal(outs[0], spec)
    set_generator(masks, torch.Generator().manual_seed(5))
    assert not torch.equal(masks(spec), outs[0])


@pytest.mark.parametrize("orig,new,length", [(44100, 16000, 4000),
                                             (48000, 16000, 3000),
                                             (8000, 16000, 1001)])
def test_resample_matches_jax(orig, new, length):
    x = _signal(length, length=length)
    want = np.asarray(jres.resample_poly(jnp.asarray(x), orig, new,
                                         use_pallas=False))
    want_pallas = np.asarray(jres.resample_poly(jnp.asarray(x), orig, new,
                                                use_pallas=True))
    got_np = resample.resample_poly_np(x, orig, new)
    got = resample.resample_poly(torch.from_numpy(x), orig, new).numpy()
    np.testing.assert_allclose(
        got_np, jres.resample_poly_np(x, orig, new), atol=1e-5)
    for g in (got_np, got):
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, atol=1e-4)
        np.testing.assert_allclose(g, want_pallas, atol=1e-4)


def test_resample_kernel_matches_jax():
    for rates in ((44100, 16000), (22050, 16000), (8000, 16000)):
        got, want = resample.resample_kernel(*rates), jres.resample_kernel(
            *rates)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_resample_poly_vs_bruteforce():
    orig, new = 44100, 16000
    x = _signal(9, b=1, length=2000)
    kernels, width, orig_g, new_g = resample.resample_kernel(orig, new)
    length = x.shape[-1]
    target = -(-new_g * length // orig_g)
    xpad = np.pad(x, [(0, 0), (width, width + orig_g)])
    out = np.zeros((1, (length // orig_g + 1) * new_g), np.float32)
    for t in range(length // orig_g + 1):
        seg = xpad[:, t * orig_g: t * orig_g + kernels.shape[1]]
        out[:, t * new_g:(t + 1) * new_g] = seg @ kernels.T
    for y in (resample.resample_poly(torch.from_numpy(x), orig, new).numpy(),
              resample.resample_poly_np(x, orig, new)):
        assert y.shape[-1] == target
        np.testing.assert_allclose(y, out[:, :target], atol=1e-4)


def test_resample_preserves_tone():
    t = np.arange(4800) / 48000.0
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)[None]
    y = resample.resample_poly(torch.from_numpy(x), 48000, 16000).numpy()[0]
    ref = np.sin(2 * np.pi * 1000 * np.arange(y.shape[-1]) / 16000.0)
    np.testing.assert_allclose(y[50:-50], ref[50:-50], atol=5e-3)
    same = torch.from_numpy(x)
    assert resample.resample_poly(same, 16000, 16000) is same
