"""The whole audio,text PhysVerbModel: port against JAX `model.apply`.

Both models come from their package's `cli.train_multimodal.build_model`
at hidden 64, 8 heads, 16 000 samples and 12 text tokens; the JAX weights
(with non-trivial BatchNorm statistics) reach the port through
io/from_jax.py.  The batch has zero-padded text rows and a `present=0` row,
whose every token is masked.  Tolerance 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import train_multimodal as jtm
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_multimodal as ttm)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from tests.test_torch_cnn1d import randomize_norms

HIDDEN, SAMPLES, TOKENS = 64, 16000, 12


def flagship_pair(seed=0, hidden=HIDDEN, samples=SAMPLES, tokens=TOKENS):
    """(JAX model, numpy variables, port model with the same weights)."""
    kw = dict(hidden_size=hidden, fusion_heads=8, audio_samples=samples,
              text_tokens=tokens)
    modalities = ("audio", "text")
    jmodel = jtm.build_model(jtm.MultimodalConfig(**kw), modalities)
    example = {"audio": {"data": np.zeros((1, samples), np.float32),
                         "present": np.ones((1,), np.float32)},
               "text": {"data": np.zeros((1, tokens, hidden), np.float32),
                        "present": np.ones((1,), np.float32)}}
    variables = randomize_norms(
        jax.jit(jmodel.init)(jax.random.PRNGKey(seed), example), seed)
    port = ttm.build_model(ttm.MultimodalConfig(**kw), modalities)
    return jmodel, variables, load_jax_variables(port, variables).eval()


def _batch(b=4):
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((b, SAMPLES)) * 0.1).astype(np.float32)
    text = rng.standard_normal((b, TOKENS, HIDDEN)).astype(np.float32)
    text[0, 7:] = 0.0  # zero-padded (masked) token rows
    present = np.ones((b,), np.float32)
    present[-1] = 0.0  # an absent row: every token masked
    return {"audio": {"data": audio, "present": present},
            "text": {"data": text, "present": present}}


@pytest.fixture(scope="module")
def pair():
    return flagship_pair()


@pytest.mark.parametrize("present", ["audio,text", "audio"])
def test_flagship_logits_match_jax(pair, present):
    """`audio` alone: the text modality becomes the static zero stub."""
    jmodel, variables, port = pair
    batch = {m: v for m, v in _batch().items() if m in present.split(",")}
    want = jax.jit(jmodel.apply)(variables, batch)
    with torch.inference_mode():
        got = port({m: {k: torch.from_numpy(a) for k, a in v.items()}
                    for m, v in batch.items()})
    assert sorted(got) == sorted(want) == ["phys", "verb"]
    for head in want:
        assert got[head].shape == (4, 2)
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                   atol=1e-4)


def test_audio_token_count_matches_trunk():
    assert ttm.audio_tokens(80000) == 7
    assert ttm.audio_tokens(SAMPLES) == 1


def test_per_aggr_classifier_matches_jax():
    """The base PhysVerbClassifier (each head sees only its own modalities:
    audio+text -> verb, video -> phys), which the flagship does not use."""
    from multimodalaggressionrecognition_tpu.models.physverb import (
        PhysVerbClassifier as JaxClassifier)
    from multimodalaggressionrecognition_tpu_torch.models.physverb import (
        PhysVerbClassifier)

    sizes = {"audio": (16, 8), "text": (16, 10), "video": (16, 6)}
    rng = np.random.default_rng(12)
    feats = {m: rng.standard_normal((3, 5, 16)).astype(np.float32)
             for m in sizes}
    jm = JaxClassifier(class_num=2, adaptor_sizes=sizes)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), feats))
    want = jm.apply(variables, feats)
    port = load_jax_variables(PhysVerbClassifier(2, sizes), variables).eval()
    assert port.head_in_dims() == {"verb": 18, "phys": 6}
    with torch.inference_mode():
        got = port({m: torch.from_numpy(f) for m, f in feats.items()})
    assert sorted(got) == sorted(want) == ["phys", "verb"]
    for head in want:
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                   atol=1e-5)
