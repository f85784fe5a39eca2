"""The model pieces no CLI builds, port against JAX: the Averaged and
CrossAttention fusions, EmbeddingLayer, VideoAverageFeatures,
AudioTextAdaptor, OutputClassifier, TransformerSequenceClassifier with an
extractor, PhysVerbClassifierAddFeatures and MultimodalModel.

Each runs on the JAX module's weights through io/from_jax.py (strict
loading) at the heads' tolerance, 1e-5 (tests/test_torch_flagship.py),
eval mode: the fusions with zero-padded rows, a missing modality's zero
stub and a row whose keys are all masked; the three adaptor
combinations; 2-D and 3-D classifier inputs; a frozen extractor that
gets no gradient (JAX: `stop_gradient`) and an unfrozen one whose
gradients match `jax.grad`'s.  Under bf16 the dtype of every module
output both packages name equals flax's captured intermediates
(tests/test_torch_bf16_entries.py's check).  The slice as a whole: the
tri-modal towers of cli.train_multimodal.build_model (the real Swin3D-T
on 16 frames at 32 px) under a CrossAttentionFusion with a
MultimodalModel, and under an AveragedFeaturesTransformerFusion with
PhysVerbClassifierAddFeatures, logits at 1e-4 (tests/test_torch_trimodal.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu.models import audiotext as jat
from multimodalaggressionrecognition_tpu.models import fusion as jfu
from multimodalaggressionrecognition_tpu.models import heads as jhe
from multimodalaggressionrecognition_tpu.models import physverb as jpv
from multimodalaggressionrecognition_tpu.utils.precision import (
    cast_floating as jax_cast)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_multimodal as ttm)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models import audiotext as tat
from multimodalaggressionrecognition_tpu_torch.models import fusion as tfu
from multimodalaggressionrecognition_tpu_torch.models import heads as the
from multimodalaggressionrecognition_tpu_torch.models import physverb as tpv
from multimodalaggressionrecognition_tpu_torch.train.steps import forward
from test_torch_bf16_entries import (assert_same_flow, jax_dtypes,
                                     port_dtypes)
from test_torch_train_step import torch_tree
from test_torch_trimodal import (MODALITIES, SIZES, _torch, batch,
                                 random_variables)

H, HEADS = 32, 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _feats(case="all", n=3, seed=0):
    """{audio (n, 6, H), text (n, 4, H), video (n, 2, H)}: text row 0 has
    zero-padded tokens; 'missing video' makes video the zero stub; 'no
    keys' zeroes row n-1 of text and video, so audio's queries there have
    no valid key."""
    rng = np.random.default_rng(seed)
    feats = {m: rng.standard_normal((n, t, H)).astype(np.float32)
             for m, t in (("audio", 6), ("text", 4), ("video", 2))}
    feats["text"][0, 2:] = 0.0
    if case == "missing video":
        feats["video"][:] = 0.0
    elif case == "no keys":
        feats["text"][-1] = 0.0
        feats["video"][-1] = 0.0
    return feats


def _init(jm, *args):
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), *args))


def _close(got, want, atol=1e-5):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


def _t(tree):
    return torch_tree(tree) if isinstance(tree, dict) else torch.from_numpy(
        tree)


def _run(port, variables, inputs):
    port = load_jax_variables(port, variables).eval()
    with torch.no_grad():
        return port(_t(inputs))


def test_averaged_fusion_matches_jax():
    feats = _feats("missing video")
    jm = jfu.AveragedFeaturesTransformerFusion(1, H, HEADS)
    variables = _init(jm, feats)
    want = jm.apply(variables, feats)
    got = _run(tfu.AveragedFeaturesTransformerFusion(1, H, HEADS), variables,
               feats)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        m: (3, 1, H) for m in MODALITIES}
    assert not got["video"].any()  # the stub's token is masked and zeroed
    _close(got, want)


@pytest.mark.parametrize("case", ["all", "missing video", "no keys"])
def test_cross_attention_fusion_matches_jax(case):
    feats = _feats(case)
    jm = jfu.CrossAttentionFusion(hidden_size=H, num_heads=HEADS)
    variables = _init(jm, feats)
    want = jm.apply(variables, feats)
    got = _run(tfu.CrossAttentionFusion(H, HEADS), variables, feats)
    _close(got, want)
    if case == "no keys":  # zero attention: the residual plus out_proj's bias
        port = tfu.CrossAttentionFusion(H, HEADS)
        load_jax_variables(port, variables).eval()
        q = torch.from_numpy(feats["audio"][-1:])
        bias = port.cross_attn.out_proj.bias
        with torch.no_grad():
            _close(got["audio"][-1:], port.norm(q + bias).numpy())


@pytest.mark.parametrize("combination", ["concat", "sum", "mean"])
def test_audio_text_adaptor_matches_jax(combination):
    feats = {m: f for m, f in _feats().items() if m != "video"}
    jm = jhe.AudioTextAdaptor(target_dim=8, combination=combination)
    variables = _init(jm, feats)
    port = the.AudioTextAdaptor(8, input_sizes={"audio": H, "text": H},
                                combination=combination)
    got = _run(port, variables, feats)
    assert got.shape == (3, 16 if combination == "concat" else 8)
    _close(got, jm.apply(variables, feats))
    only_audio = {"audio": feats["audio"]}  # an absent modality is skipped
    _close(_run(port, variables, only_audio), jm.apply(variables, only_audio))


@pytest.mark.parametrize("shape", [(3, 5, H), (3, H)])
def test_output_classifier_matches_jax(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jm = jhe.OutputClassifier(class_num=3)
    variables = _init(jm, x)
    got = _run(the.OutputClassifier(3, input_size=H), variables, x)
    assert got.shape == (3, 3)
    _close(got, jm.apply(variables, x))


def test_embedding_layer_and_video_average_features_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, H)).astype(np.float32)
    jm = jhe.EmbeddingLayer(8)
    variables = _init(jm, x)
    got = _run(the.EmbeddingLayer(8, input_size=H), variables, x)
    assert got.shape == (2, 5, 8) and (got >= 0).all()
    _close(got, jm.apply(variables, x))
    jm = jhe.VideoAverageFeatures(class_num=3)
    variables = _init(jm, x)
    _close(_run(the.VideoAverageFeatures(3, input_size=H), variables, x),
           jm.apply(variables, x))


@pytest.mark.parametrize("freeze", [True, False])
def test_sequence_classifier_with_extractor_matches_jax(freeze):
    """An EmbeddingLayer extractor (8 -> H) under a 1-layer encoder: the
    logits, and every gradient of sum(logits ** 2) against jax.grad's in
    train mode (the extractor runs in eval mode either way, as JAX calls it
    without `train`; the dropouts at 0).  Frozen, the extractor's
    parameters get no gradient (JAX's are 0)."""
    x = np.random.default_rng(4).standard_normal((2, 5, 8)).astype(np.float32)
    jm = jhe.TransformerSequenceClassifier(
        class_num=2, hidden_size=H, num_layers=1, num_heads=HEADS,
        dropout=0.0, extractor=jhe.EmbeddingLayer(H),
        freeze_extractor=freeze)
    variables = _init(jm, x)
    assert "extractor" in variables["params"]
    want = jm.apply(variables, x)
    grads = jax.grad(lambda v: jnp.sum(jm.apply(v, x) ** 2))(variables)
    port = the.TransformerSequenceClassifier(
        2, H, num_layers=1, num_heads=HEADS, dropout=0.0,
        extractor=the.EmbeddingLayer(H, input_size=8), freeze_extractor=freeze)
    load_jax_variables(port, variables)
    for m in port.encoder.modules():  # the encoder's own dropout off
        if hasattr(m, "rate"):
            m.rate = 0.0
    port.train()
    assert port.training and not port.extractor.training
    logits = port(torch.from_numpy(x))
    _close(logits, want)
    torch.sum(logits ** 2).backward()
    want_grads = from_jax_variables(jax.tree.map(np.asarray, grads))
    for name, p in port.named_parameters():
        if freeze and name.startswith("extractor."):
            assert not p.requires_grad and p.grad is None, name
            assert not np.asarray(want_grads[name]).any(), name
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_physverb_add_features_matches_jax():
    feats = _feats()
    sizes = {m: (H, 8) for m in MODALITIES}
    jm = jpv.PhysVerbClassifierAddFeatures(class_num=2, adaptor_sizes=sizes)
    variables = _init(jm, feats)
    port = tpv.PhysVerbClassifierAddFeatures(2, sizes)
    assert port.head_names() == jm.head_names() == ["verb", "phys"]
    assert port.head_in_dims() == {"verb": 8, "phys": 8}
    _close(_run(port, variables, feats), jm.apply(variables, feats))
    with pytest.raises(ValueError, match="one output width"):
        tpv.PhysVerbClassifierAddFeatures(2, {"audio": (H, 8),
                                              "text": (H, 4)})


def test_multimodal_model_matches_jax_and_keeps_head_order():
    """One OutputClassifier per fused stream, given text first: the heads
    come out in that order; `classifier` None; the `classifiers_<m>` names
    cross the bridge."""
    feats = _feats()
    b = {m: {"data": f, "present": np.asarray([1, 1, 0], np.float32)}
         for m, f in feats.items() if m != "video"}
    jm = jat.MultimodalModel(
        extractors={"audio": jpv.IdentityExtractor(),
                    "text": jpv.IdentityExtractor()},
        fusion=jfu.EqualSizedTransformerModalitiesFusion(1, H, HEADS),
        classifier=None,
        classifiers={"text": jhe.OutputClassifier(class_num=3),
                     "audio": jhe.OutputClassifier(class_num=2)},
        feature_shapes={"video": (2, H)}, modalities=MODALITIES)
    variables = _init(jm, b)
    assert sorted(variables["params"]) == [
        "classifiers_audio", "classifiers_text", "fusion"]
    port = tat.MultimodalModel(
        extractors={"audio": tpv.IdentityExtractor(),
                    "text": tpv.IdentityExtractor()},
        classifiers={"text": the.OutputClassifier(3, input_size=H),
                     "audio": the.OutputClassifier(2, input_size=H)},
        fusion=tfu.EqualSizedTransformerModalitiesFusion(1, H, HEADS),
        feature_shapes={"video": (2, H)}, modalities=MODALITIES)
    assert port.classifier is None
    assert port.head_names() == ["text", "audio"]
    assert jm.head_names() == ["text", "audio"]
    got = _run(port, variables, b)
    assert list(got) == ["text", "audio"]
    _close(got, jm.apply(variables, b))


# bf16: each module's output dtypes against flax's captured intermediates

def _bf16_cases():
    feats = _feats("missing video")
    sizes = {m: (H, 8) for m in MODALITIES}
    x3 = np.random.default_rng(5).standard_normal((2, 5, H)).astype(np.float32)
    x8 = np.random.default_rng(6).standard_normal((2, 5, 8)).astype(np.float32)
    return {
        "cross_attention": (jfu.CrossAttentionFusion(hidden_size=H,
                                                     num_heads=HEADS),
                            lambda: tfu.CrossAttentionFusion(H, HEADS), feats),
        "averaged": (jfu.AveragedFeaturesTransformerFusion(1, H, HEADS),
                     lambda: tfu.AveragedFeaturesTransformerFusion(1, H,
                                                                   HEADS),
                     feats),
        "adaptor": (jhe.AudioTextAdaptor(target_dim=8),
                    lambda: the.AudioTextAdaptor(
                        8, input_sizes={"audio": H, "text": H}),
                    {m: feats[m] for m in ("audio", "text")}),
        "output_classifier": (jhe.OutputClassifier(class_num=2),
                              lambda: the.OutputClassifier(2, input_size=H),
                              x3),
        "video_average": (jhe.VideoAverageFeatures(class_num=2),
                          lambda: the.VideoAverageFeatures(2, input_size=H),
                          x3),
        "sequence_classifier": (
            jhe.TransformerSequenceClassifier(
                class_num=2, hidden_size=H, num_layers=1, num_heads=HEADS,
                extractor=jhe.EmbeddingLayer(H), freeze_extractor=True),
            lambda: the.TransformerSequenceClassifier(
                2, H, num_layers=1, num_heads=HEADS,
                extractor=the.EmbeddingLayer(H, input_size=8),
                freeze_extractor=True), x8),
        "add_features": (jpv.PhysVerbClassifierAddFeatures(
            class_num=2, adaptor_sizes=sizes),
            lambda: tpv.PhysVerbClassifierAddFeatures(2, sizes), feats),
    }


BF16_CASES = _bf16_cases()


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_dtypes_follow_flax(name):
    jm, make_port, inputs = BF16_CASES[name]
    variables = _init(jm, inputs)
    v16 = {"params": jax_cast(variables["params"], jnp.bfloat16)}
    out, state = jm.apply(v16, jax_cast(inputs, jnp.bfloat16),
                          capture_intermediates=True,
                          mutable=["intermediates"])
    want = jax_dtypes(state["intermediates"])
    port = load_jax_variables(make_port(), variables).eval()
    with torch.no_grad():
        got, got_out = port_dtypes(port, lambda: forward(port, _t(inputs),
                                                         "bfloat16"))
    shared = assert_same_flow(want, got, ())
    assert len(shared) >= 2, (sorted(want), sorted(got))
    outs = got_out if isinstance(got_out, dict) else {"": got_out}
    wants = out if isinstance(out, dict) else {"": out}
    assert {k: str(v.dtype).replace("torch.", "") for k, v in outs.items()} \
        == {k: str(v.dtype) for k, v in wants.items()}
    _close({k: v.float() for k, v in outs.items()},
           {k: np.asarray(v.astype(jnp.float32)) for k, v in wants.items()},
           atol=0.05 * max(float(np.abs(np.asarray(
               v.astype(jnp.float32))).max()) for v in wants.values()))


# the slice as a whole: the tri-modal towers under the new pieces

def _pieces(pkg):
    """{name: (fusion, classifier or None, classifiers or None)} of
    package `pkg` ('jax' or 'port'), at the tri-modal width."""
    width, sizes = SIZES["hidden_size"], {m: (768, 256) for m in MODALITIES}
    if pkg == "jax":
        return {
            "cross_attention": (
                jfu.CrossAttentionFusion(hidden_size=width, num_heads=8),
                None, {m: jhe.OutputClassifier(class_num=2)
                       for m in MODALITIES}),
            "averaged": (
                jfu.AveragedFeaturesTransformerFusion(1, width, 8),
                jpv.PhysVerbClassifierAddFeatures(class_num=2,
                                                  adaptor_sizes=sizes),
                None)}
    return {
        "cross_attention": (
            tfu.CrossAttentionFusion(width, 8), None,
            {m: the.OutputClassifier(2, input_size=width)
             for m in MODALITIES}),
        "averaged": (
            tfu.AveragedFeaturesTransformerFusion(1, width, 8),
            tpv.PhysVerbClassifierAddFeatures(2, sizes), None)}


def _assemble(base, fusion, classifier, classifiers, multimodal_cls,
              physverb_cls):
    kw = dict(extractors=dict(base.extractors), fusion=fusion,
              feature_shapes=dict(base.feature_shapes),
              modalities=tuple(base.modalities))
    if classifiers is not None:
        return multimodal_cls(classifiers=classifiers, classifier=None, **kw)
    return physverb_cls(classifier=classifier, **kw)


@pytest.mark.parametrize("name", ["cross_attention", "averaged"])
def test_trimodal_towers_under_the_pieces_match_jax(name):
    jmodel = _assemble(jtm.build_model(jtm.MultimodalConfig(**SIZES),
                                       MODALITIES), *_pieces("jax")[name],
                       jat.MultimodalModel, jpv.PhysVerbModel)
    pmodel = _assemble(ttm.build_model(ttm.MultimodalConfig(**SIZES),
                                       MODALITIES), *_pieces("port")[name],
                       tat.MultimodalModel, tpv.PhysVerbModel)
    example = {m: {k: np.zeros_like(v) for k, v in d.items()}
               for m, d in batch(1).items()}
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example), seed=7)
    load_jax_variables(pmodel, variables).eval()
    assert pmodel.head_names() == jmodel.head_names()
    for present in (MODALITIES, ("audio", "text")):
        b = {m: v for m, v in batch().items() if m in present}
        want = jax.jit(jmodel.apply)(variables, b)
        with torch.inference_mode():
            got = pmodel(_torch(b))
        assert list(got) == pmodel.head_names()  # jit sorts want's keys
        assert sorted(got) == sorted(want)
        for head in want:
            assert got[head].shape == (3, 2)
            np.testing.assert_allclose(got[head].numpy(),
                                       np.asarray(want[head]), atol=1e-4,
                                       err_msg=f"{present} {head}")
