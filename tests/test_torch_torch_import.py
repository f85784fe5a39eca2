"""io/torch_import.py of the port against the JAX package's converters.

For each of the eight converters, one torch-layout state_dict (from the
torch replicas of tests/test_cnn1d.py, tests/test_video_models.py and
tests/_replicas.py, or synthesized from a JAX model as
tests/test_torch_import_wav2vec.py does) goes through the port's converter
into the port module (strict load) and through the JAX converter into the
JAX module; their outputs agree within 1e-5.  The CNN1D and its wrapper
are also held to the torch replica itself within 2e-3, as
tests/test_import_cli.py holds the JAX package's CNN1D.  Then: a dropped torch key and a dropped port key each raise, a
key no rule reads raises, and `import_torch_checkpoint.main` writes a port
checkpoint that `restore_variables` loads back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_cnn1d
import test_torch_import_wav2vec
import test_video_models
from _replicas import _TS3D, _TSwin3dT
from multimodalaggressionrecognition_tpu.io import torch_import as jti
from multimodalaggressionrecognition_tpu.models import cnn1d as jcnn1d
from multimodalaggressionrecognition_tpu.models import r3d as jr3d
from multimodalaggressionrecognition_tpu.models import s3d as js3d
from multimodalaggressionrecognition_tpu.models import swin3d as jswin
from multimodalaggressionrecognition_tpu.models import vgg as jvgg
from multimodalaggressionrecognition_tpu.models import wav2vec as jw2v
from multimodalaggressionrecognition_tpu_torch.cli import (
    import_torch_checkpoint)
from multimodalaggressionrecognition_tpu_torch.io import torch_import as ti
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    restore_variables)
from multimodalaggressionrecognition_tpu_torch.models import cnn1d, r3d, s3d
from multimodalaggressionrecognition_tpu_torch.models import swin3d, vgg
from multimodalaggressionrecognition_tpu_torch.models import wav2vec
from multimodalaggressionrecognition_tpu_torch.models.nn3d import (
    global_avg_pool)
from multimodalaggressionrecognition_tpu_torch.models.r3d import (
    to_channels_first)

SWIN = dict(embed_dim=8, depths=(1, 1), num_heads=(2, 4), window=(2, 3, 3))
W2V = test_torch_import_wav2vec.CFG


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _replica_sd(module, seed):
    """A torch replica's state_dict with its BatchNorm statistics drawn
    from `seed` (torch's init leaves them at 0 and 1)."""
    torch.manual_seed(seed)
    tm = module().eval()
    g = torch.Generator().manual_seed(seed)
    for m in tm.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return tm, {k: v.clone() for k, v in tm.state_dict().items()}


def _np(sd):
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _jax_apply(model, variables, x):
    return np.asarray(jax.jit(model.apply)(jax.tree.map(jnp.asarray,
                                                        variables), x))


def _torch_run(fn, x):
    with torch.inference_mode():
        return fn(torch.from_numpy(x)).numpy()


def _cnn1d():
    tm, sd = _replica_sd(lambda: test_cnn1d._TorchCNN1D(3), 1)
    x = _x((2, 16000), 2, 0.1)
    with torch.inference_mode():
        replica = tm(torch.from_numpy(x[:, None, :])).numpy()
    return dict(sd=sd, port=cnn1d.CNN1D(3), jax=jcnn1d.CNN1D(3), x=x,
                replica=replica)


def _wrapper():
    tm, sd = _replica_sd(lambda: test_cnn1d._TorchWrapper(32), 3)
    x = _x((2, 16000), 4, 0.1)
    with torch.inference_mode():
        replica = tm(torch.from_numpy(x[:, None, :])).numpy()
    return dict(sd=sd, port=cnn1d.AudioCnn1DExtractorWrapper(32),
                jax=jcnn1d.AudioCnn1DExtractorWrapper(32), x=x,
                replica=replica)


def _r3d18():
    _, sd = _replica_sd(lambda: test_video_models._TR3D18(5), 5)
    return dict(sd=sd, port=r3d.R3D18Classifier(5),
                jax=jr3d.R3D18Classifier(5), x=_x((1, 4, 32, 32, 3), 6))


def _vgg11_bn():
    _, sd = _replica_sd(lambda: test_video_models._TVGG11BN(5), 7)
    model = vgg.VGG11BN(5)
    return dict(sd=sd, port=model, jax=jvgg.VGG11BN(5),
                x=_x((1, 32, 32, 3), 8),
                port_fn=lambda x: model(x.permute(0, 3, 1, 2)))


def _swin3d_t():
    torch.manual_seed(9)
    tm = _TSwin3dT(embed_dim=8, depths=(1, 1), heads=(2, 4),
                   window=(2, 3, 3)).eval()
    sd = dict(tm.state_dict())
    # torchvision's swin3d_t carries its Kinetics classifier: dropped
    sd["head.weight"], sd["head.bias"] = torch.zeros(4, 16), torch.zeros(4)
    return dict(sd=sd, port=swin3d.SwinTransformer3d(**SWIN),
                jax=jswin.SwinTransformer3d(**SWIN),
                x=_x((1, 4, 12, 12, 3), 10), convert_kw=dict(depths=(1, 1)))


def _s3d():
    """The features (pooled, as the headless extractor) and the conv head
    apart: the head's (2, 7, 7) pool needs a 224 px clip."""
    _, sd = _replica_sd(lambda: _TS3D(num_classes=4), 11)
    model = s3d.S3DClassifier(4)
    x = _x((1, 16, 64, 64, 3), 12)
    h = _x((1, 1024, 2, 7, 7), 13, 1.0)

    def port_fn(v):
        feats = global_avg_pool(model.features(to_channels_first(v)))
        return torch.cat([feats, model.head(torch.from_numpy(h)).flatten(1)],
                         1)

    def jax_fn(variables, v):
        feats = _jax_apply(js3d.S3DExtractor(), {
            "params": {"features": variables["params"]["features"]},
            "batch_stats": variables["batch_stats"]}, v)
        head = js3d.Conv3d(4, 1).apply({"params": variables["params"]["head"]},
                                       h.transpose(0, 2, 3, 4, 1))
        return np.concatenate([feats, np.asarray(head).transpose(
            0, 4, 1, 2, 3).reshape(1, -1)], 1)

    return dict(sd=sd, port=model, jax=None, x=x, port_fn=port_fn,
                jax_fn=jax_fn)


def _w2v_sd():
    variables = jax.jit(jw2v.Wav2Vec2Model(W2V).init)(
        jax.random.PRNGKey(14), jnp.zeros((1, 800), jnp.float32))
    return test_torch_import_wav2vec._to_torch_sd(variables["params"])


def _wav2vec2():
    return dict(sd=_w2v_sd(), port=wav2vec.Wav2Vec2Model(
        wav2vec.Wav2Vec2Config(**vars(W2V))), jax=jw2v.Wav2Vec2Model(W2V),
        x=_x((1, 800), 15, 1.0),
        convert_kw=dict(num_layers=2, extractor_layers=2))


def _wav2vec2_hf():
    """The same weights under HF's names, the positional conv's weight norm
    in the parametrize naming, and HF's training-time mask embedding."""
    hf = {}
    for k, v in _w2v_sd().items():
        for theirs, ours in ti._HF_RENAMES:
            if k.startswith(ours):
                k = theirs + k[len(ours):]
                break
        k = k.replace("conv.weight_g", "conv.parametrizations.weight.original0")
        k = k.replace("conv.weight_v", "conv.parametrizations.weight.original1")
        hf[k] = v
    hf["masked_spec_embed"] = np.zeros(W2V.embed_dim, np.float32)
    return dict(sd=hf, port=wav2vec.Wav2Vec2Model(
        wav2vec.Wav2Vec2Config(**vars(W2V))), jax=jw2v.Wav2Vec2Model(W2V),
        x=_x((1, 800), 16, 1.0),
        convert_kw=dict(num_layers=2, extractor_layers=2))


CASES = {"cnn1d": _cnn1d, "audio_cnn1d_wrapper": _wrapper, "r3d18": _r3d18,
         "vgg11_bn": _vgg11_bn, "swin3d_t": _swin3d_t, "s3d": _s3d,
         "wav2vec2": _wav2vec2, "wav2vec2_hf": _wav2vec2_hf}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_the_jax_converter(name):
    case = CASES[name]()
    kw = case.get("convert_kw", {})
    model = case["port"]
    model.load_state_dict(getattr(ti, name)(case["sd"], **kw), strict=True)
    model.eval()
    got = _torch_run(case.get("port_fn", model), case["x"])
    variables = getattr(jti, name)(_np(case["sd"]), **kw)
    want = (case["jax_fn"](variables, case["x"]) if "jax_fn" in case
            else _jax_apply(case["jax"], variables, case["x"]))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if "replica" in case:
        np.testing.assert_allclose(got.reshape(case["replica"].shape),
                                   case["replica"], atol=2e-3, rtol=0)

    # a torch key the model needs, dropped: the converter raises (a missing
    # Sequential conv shifts the index rules, which then leave keys unread)
    needed = next(k for k in case["sd"] if k.endswith("weight"))
    short = {k: v for k, v in case["sd"].items() if k != needed}
    with pytest.raises((KeyError, ValueError)):
        getattr(ti, name)(short, **kw)
    # a port key dropped after conversion: strict loading raises
    converted = getattr(ti, name)(case["sd"], **kw)
    converted.pop(next(iter(converted)))
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(converted, strict=True)
    # a key no rule reads raises
    extra = dict(case["sd"], **{"unused.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no rule consumes.*unused.weight"):
        getattr(ti, name)(extra, **kw)


def test_import_cli_round_trip(tmp_path):
    tm, sd = _replica_sd(lambda: test_cnn1d._TorchCNN1D(2), 17)
    pt = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": sd, "epoch": 3}, pt)
    out = str(tmp_path / "converted")
    assert import_torch_checkpoint.main([
        "--model", "cnn1d", "--torch_path", pt, "--out_dir", out]) == out
    state_dict, meta = restore_variables(out)
    assert meta == {"model": "cnn1d", "source": pt}
    want = ti.cnn1d(sd)
    assert sorted(state_dict) == sorted(want)
    for k in want:
        assert torch.equal(state_dict[k], want[k]), k
    model = cnn1d.CNN1D(2)
    model.load_state_dict(state_dict, strict=True)
    x = _x((1, 16000), 18, 0.1)
    with torch.inference_mode():
        ref = tm(torch.from_numpy(x[:, None, :])).numpy()
    np.testing.assert_allclose(_torch_run(model.eval(), x), ref, atol=2e-3)
    # a bare state_dict and an nn.Module load alike
    torch.save(tm, str(tmp_path / "module.pt"))
    for path in (str(tmp_path / "module.pt"),):
        loaded = import_torch_checkpoint.load_state_dict(path)
        assert sorted(loaded) == sorted(sd)
    with pytest.raises(ValueError, match="unknown model"):
        import_torch_checkpoint.convert("resnet50", sd)
