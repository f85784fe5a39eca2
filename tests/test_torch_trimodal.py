"""The whole tri-modal (audio, text, video) PhysVerbModel: port against JAX.

Both models come from their package's `cli.train_multimodal.build_model`
with hidden 768 and the real Swin3D-T tower, on tiny inputs: 2-3 clips of
16 frames at 32 px (two 8-frame windows each), 16 000 samples (the fewest
that leave the CNN1D trunk a token) and 8 text tokens.  The JAX tree's
shapes come from `eval_shape` and its leaves from a numpy generator (every
weight and statistic non-trivial); they reach the port through
io/from_jax.py with strict loading.  Logits are held at 1e-4 and the video
tower's features at 1e-3 (tests/test_swin_s3d_parity.py's bound for the
full Swin3D-T).  The served path is the CPU `build_server`.
"""

import io
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu.serve import (
    Predictor as JaxPredictor)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_multimodal as ttm)
from multimodalaggressionrecognition_tpu_torch.cli.serve import (
    ServeConfig, build_server)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    ShiftedWindowAttention3d)

MODALITIES = ("audio", "text", "video")
SIZES = dict(hidden_size=768, fusion_heads=8, audio_samples=16000,
             text_tokens=8, video_frames=16, video_size=32, video_window=8)
HIDDEN, SAMPLES, TOKENS = 768, 16000, 8
FRAMES, SIZE = 16, 32


def random_variables(shapes, seed):
    """Numpy leaves for a JAX variables tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "mean":
            return 0.1 * rng.standard_normal(s.shape)
        if name == "relative_position_bias_table":
            return 0.5 * rng.standard_normal(s.shape)
        if name.endswith("kernel"):
            bound = float(np.prod(s.shape[:-1])) ** -0.5
            return rng.uniform(-bound, bound, s.shape)
        return rng.uniform(-0.05, 0.05, s.shape)  # biases

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def batch(n=3, seed=21):
    """n clips; the last row is absent (present=0), as a padded serving row."""
    rng = np.random.default_rng(seed)
    present = np.ones((n,), np.float32)
    present[-1] = 0.0
    text = rng.standard_normal((n, TOKENS, HIDDEN)).astype(np.float32)
    text[0, 5:] = 0.0  # zero-padded (masked) token rows
    data = {"audio": (rng.standard_normal((n, SAMPLES)) * 0.1),
            "text": text,
            "video": rng.standard_normal((n, FRAMES, SIZE, SIZE, 3)) * 0.3}
    return {m: {"data": d.astype(np.float32), "present": present}
            for m, d in data.items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, numpy variables, port model with the same weights)."""
    jmodel = jtm.build_model(jtm.MultimodalConfig(**SIZES), MODALITIES)
    example = {m: {k: np.zeros_like(v) for k, v in d.items()}
               for m, d in batch(1).items()}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example)
    variables = random_variables(shapes, seed=3)
    port = ttm.build_model(ttm.MultimodalConfig(**SIZES), MODALITIES)
    return jmodel, variables, load_jax_variables(port, variables).eval()


def _torch(b):
    return {m: {k: torch.from_numpy(a) for k, a in d.items()}
            for m, d in b.items()}


@pytest.mark.parametrize("present", ["audio,text,video", "audio,text"])
def test_trimodal_logits_match_jax(pair, present):
    """`audio,text`: video becomes the static zero stub."""
    jmodel, variables, port = pair
    b = {m: v for m, v in batch().items() if m in present.split(",")}
    want = jax.jit(jmodel.apply)(variables, b)
    with torch.inference_mode():
        got = port(_torch(b))
    assert sorted(got) == sorted(want) == ["phys", "verb"]
    for head in want:
        assert got[head].shape == (3, 2)
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                   atol=1e-4)


def test_video_tower_features_match_jax(pair):
    jmodel, variables, port = pair
    b = batch()
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, y: m.extract_features(y)))(variables, b)
    with torch.inference_mode():
        got = port.extract_features(_torch(b))
    assert got["video"].shape == (3, FRAMES // 8, HIDDEN)
    np.testing.assert_allclose(got["video"].numpy(),
                               np.asarray(want["video"]), atol=1e-3)
    assert (got["video"][-1] == 0).all()  # the present=0 row


def test_build_model_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="dots"):
        ttm.build_model(ttm.MultimodalConfig(**SIZES, video_freeze=False,
                                             video_remat_policy="dots"),
                        MODALITIES)
    with pytest.raises(ValueError, match="remat_policy"):
        ttm.build_model(ttm.MultimodalConfig(**SIZES, video_freeze=False,
                                             video_remat_policy="dot"),
                        MODALITIES)
    with pytest.raises(ValueError, match="hidden_size must be 768"):
        ttm.build_model(ttm.MultimodalConfig(**dict(SIZES, hidden_size=64)),
                        MODALITIES)
    with pytest.raises(ValueError, match="gelu must be"):
        ttm.build_model(ttm.MultimodalConfig(**SIZES, swin_gelu="exact"),
                        ("video",))


def test_seeded_init_fills_the_video_tower():
    model = ttm.build_model(ttm.MultimodalConfig(**SIZES), ("video",))
    a = seeded_init_(model, seed=4).state_dict()
    b = seeded_init_(ttm.build_model(ttm.MultimodalConfig(**SIZES),
                                     ("video",)), seed=4).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    tables = [m.relative_position_bias_table for m in model.modules()
              if isinstance(m, ShiftedWindowAttention3d)]
    assert len(tables) == 12
    for t in tables:
        assert 0 < t.abs().max() <= 0.04 and 0.01 < t.std() < 0.03
    conv = model.extractors["video"].backbone.backbone.patch_embed
    assert 0 < conv.weight.abs().max() <= (3 * 2 * 4 * 4) ** -0.5


# ------------------------------------------------------------ HTTP server

@pytest.fixture(scope="module")
def server(pair):
    cfg = ServeConfig(modalities="audio,text,video", **SIZES, batch_size=2,
                      max_delay_ms=20.0, port=0, device="cpu")
    srv = build_server(cfg, state_dict=from_jax_variables(pair[1]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.batcher.close()
    thread.join(timeout=10)


def _post(srv, body, ctype):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}/score", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_trimodal_server_scores_npz_and_a_short_json_clip(server, pair):
    jmodel, variables, _ = pair
    req = {m: d["data"] for m, d in batch(3, seed=22).items()}
    buf = io.BytesIO()
    np.savez(buf, **req)
    got = _post(server, buf.getvalue(), "application/x-npz")
    assert len(got["phys"]) == 3  # chunked 2 + 1
    want = JaxPredictor(jmodel, variables, batch_size=2)
    direct = np.concatenate([want.predict({k: v[s:s + 2]
                                           for k, v in req.items()})["phys"]
                             for s in (0, 2)])
    np.testing.assert_allclose(np.asarray(got["phys"]), direct, atol=1e-3)

    rng = np.random.default_rng(23)
    short = {"audio": (rng.standard_normal(5000) * 0.1).round(3),
             "text": rng.standard_normal((3, HIDDEN)).round(3),
             "video": (rng.standard_normal((8, SIZE, SIZE, 3)) * 0.3).round(3)}
    got = _post(server, json.dumps({k: v.tolist() for k, v in short.items()})
                .encode(), "application/json")
    padded = {"audio": np.pad(short["audio"], (0, SAMPLES - 5000)),
              "text": np.pad(short["text"], ((0, TOKENS - 3), (0, 0))),
              "video": np.pad(short["video"],
                              ((0, FRAMES - 8), (0, 0), (0, 0), (0, 0)))}
    want = want.predict({k: v[None].astype(np.float32)
                         for k, v in padded.items()})
    for head in ("phys", "verb"):
        np.testing.assert_allclose(got[head][0], want[head][0], atol=1e-3)
