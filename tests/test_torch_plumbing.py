"""Port plumbing: import isolation, device rules, weight-bridge strictness,
checkpoints, config parsing, and the kernels' build keys, signatures and
tensor checks."""

import ctypes
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models import layers as jl
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.cli.serve import (
    ServeConfig, build_server)
from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
    MultimodalConfig, build_model)
from multimodalaggressionrecognition_tpu_torch.io import checkpoint
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import layers as tl
from multimodalaggressionrecognition_tpu_torch.serve import Predictor
from multimodalaggressionrecognition_tpu_torch.utils import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "multimodalaggressionrecognition_tpu_torch"

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import {PORT} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
jax_pkg = "multimodalaggressionrecognition_tpu"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
             or m == jax_pkg or m.startswith(jax_pkg + "."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """In a fresh interpreter (this one has jax loaded by conftest), import
    every port module and list what got loaded.  Names are compared
    exactly: the port's own name starts with the JAX package's."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20  # every module of the slice was imported
    assert bad.strip() == "[]"


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    model = build_model(MultimodalConfig(hidden_size=32, fusion_heads=4,
                                         audio_samples=16000, text_tokens=4),
                        ("audio", "text"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(ServeConfig(allow_random_weights=True, port=0))


def _mhsa_vars():
    jm = jl.MultiheadSelfAttention(16, 2)
    return jax.tree.map(np.asarray,
                        jm.init(jax.random.PRNGKey(0), np.zeros((1, 3, 16),
                                                                np.float32)))


def test_converter_raises_on_missing_and_extra_leaves():
    variables = _mhsa_vars()
    load_jax_variables(tl.MultiheadSelfAttention(16, 2), variables)  # exact

    missing = {"params": dict(variables["params"])}
    del missing["params"]["out_proj_bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(tl.MultiheadSelfAttention(16, 2), missing)

    extra = {"params": dict(variables["params"], out_proj_bias=np.zeros(16),
                            rotary=np.zeros(4, np.float32))}
    with pytest.raises(ValueError, match="unconsumed JAX leaf params/rotary"):
        from_jax_variables(extra)
    with pytest.raises(ValueError, match="unconsumed JAX collections"):
        from_jax_variables({**variables, "quant": {}})
    # a leaf the rules know, where the port has no such parameter
    unknown = {"params": dict(variables["params"],
                              extra_proj={"kernel": np.zeros((16, 16))})}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_variables(tl.MultiheadSelfAttention(16, 2), unknown)


def test_checkpoint_round_trip(tmp_path):
    model = tl.seeded_init_(tl.TransformerEncoder(16, 2, 1, 32), seed=5)
    path = str(tmp_path / "ckpt" / "model.pt")
    checkpoint.save_variables(path, model.state_dict(), {"epoch": 3})
    sd, meta = checkpoint.restore_variables(path)
    assert meta == {"epoch": 3}
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_parse_config_and_video_is_a_later_slice():
    cfg = parse_config(ServeConfig, ["--device", "cpu", "--allow_random_weights",
                                     "--batch_size", "8"])
    assert (cfg.device, cfg.allow_random_weights, cfg.batch_size) == (
        "cpu", True, 8)
    assert parse_config(ServeConfig, ["--allow_random_weights", "no"]
                        ).allow_random_weights is False
    cfg = parse_config(ServeConfig, ["--modalities", "audio,text,video",
                                     "--video_freeze", "false"])
    assert (cfg.modalities, cfg.video_freeze) == ("audio,text,video", False)
    # --video_freeze false builds the trainable tower, remat on by default
    video = build_model(cfg, ("audio", "text", "video")).extractors["video"]
    assert not video.freeze and video.backbone.backbone.remat
    assert all(p.requires_grad for p in video.parameters())
    frozen = build_model(MultimodalConfig(modalities="audio,text,video"),
                         ("video",)).extractors["video"]
    assert not any(p.requires_grad for p in frozen.parameters())
    assert not frozen.backbone.backbone.remat
    with pytest.raises(SystemExit, match="unknown modalities"):
        build_model(MultimodalConfig(), ("audio", "depth"))


def test_kernel_library_is_keyed_by_source():
    assert {"framed_conv", "window_attention"} <= set(kernels.kernel_sources())
    path = kernels.library_path("framed_conv")
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    assert path == kernels.library_path("framed_conv")
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.check_status("framed_conv1d", 9)


def _offset_view():
    """A (2, 8) f32 view 4 bytes past a 16-byte aligned allocation."""
    base = torch.zeros(17)
    assert base.data_ptr() % 16 == 0
    return base[1:].view(2, 8)


@pytest.mark.parametrize("make,aligned,err,match", [
    (lambda: torch.zeros(2, 8, dtype=torch.float64), False, TypeError,
     "op: t must be torch.float32, got torch.float64"),
    (lambda: torch.zeros(2, 8, device="meta"), False, ValueError,
     "op: t on meta, not cpu"),
    (lambda: torch.zeros(2, 9), False, ValueError,
     r"op: t shape \(2, 9\) != \(2, 8\)"),
    (lambda: torch.zeros(8, 2).t(), False, ValueError,
     "op: t must be contiguous"),
    (_offset_view, True, ValueError, "op: t must be 16-byte aligned"),
    (_offset_view, False, None, None),
    (lambda: torch.zeros(2, 8), True, None, None),
], ids=["dtype", "device", "shape", "contiguous", "misaligned",
        "offset_unchecked", "fits"])
def test_check_tensor_names_the_op_and_the_tensor(make, aligned, err, match):
    """The one tensor check every kernel wrapper makes: TypeError for the
    dtype, ValueError for the device, shape, layout and, where asked, a
    pointer off 16 bytes."""
    t = make()
    if err is None:
        kernels.check_tensor("op", "t", t, (2, 8), torch.float32,
                             torch.device("cpu"), aligned=aligned)
        return
    with pytest.raises(err, match=match):
        kernels.check_tensor("op", "t", t, (2, 8), torch.float32,
                             torch.device("cpu"), aligned=aligned)


@pytest.mark.parametrize("codes,want", [
    ("PPif", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
              ctypes.c_void_p]),  # a launch: the stream appended
    ("iio", [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    ("iiiii", [ctypes.c_int] * 5),
], ids=["launch", "info", "count"])
def test_a_declared_signature_binds_its_ctypes_types(codes, want):
    lib = types.SimpleNamespace(entry=types.SimpleNamespace())
    kernels.bind(lib, {"entry": codes})
    assert lib.entry.argtypes == want
    assert lib.entry.restype is ctypes.c_int


def test_a_bound_entry_refuses_a_call_off_its_signature():
    """ctypes holds each call to the declaration (libc's `abs`, int(int))."""
    libc = ctypes.CDLL(None)
    kernels.bind(libc, {"abs": "i"})
    assert libc.abs(-3) == 3
    with pytest.raises(TypeError):
        libc.abs()
    with pytest.raises(ctypes.ArgumentError):
        libc.abs("3")
