"""The wav2vec transformer of the audio entry (cli/train_audio_transformer.py
--arch transformer) against the JAX package's.

With the same weights carried by io/from_jax.py and both models
deterministic, at 1 s of 16 kHz audio (98 wav2vec-1 frames): the logits
within 1e-4, the CE within 1e-5 and every gradient of the head within
1e-4 * max|g_JAX| of that tensor; the frozen wav2vec-1 encoder has no
gradient in the port and a zero one in JAX (stop_gradient), and stays in
eval mode when the model trains.
"""

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli import (
    train_audio_transformer as jcli)
from multimodalaggressionrecognition_tpu.cli.common import (
    parse_config as jax_parse_config)
from multimodalaggressionrecognition_tpu_torch.cli import (
    train_audio_transformer as tcli)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from test_torch_audio_rnn import assert_cli_model_matches_jax, labelled

ARGS = ["--arch", "transformer", "--audio_seconds", "1"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_model_logits_loss_and_gradients_match_jax():
    jmodel = jcli.make_model(jax_parse_config(jcli.AudioTransformerConfig,
                                              ARGS))
    model = tcli.make_model(parse_config(tcli.AudioTransformerConfig, ARGS))
    audio = (np.random.default_rng(4).standard_normal((3, 16000))
             * 0.1).astype(np.float32)
    trained = assert_cli_model_matches_jax(
        jmodel, model, labelled("audio", audio, ("main",)), ("main",))
    assert trained == len(list(model.heads.parameters()))


def test_frozen_extractor_stays_in_eval_mode():
    model = tcli.make_model(parse_config(tcli.AudioTransformerConfig, ARGS))
    model.train()
    assert model.heads.main.training and not model.extractor.training
    assert all(not m.training for m in model.extractor.modules())
    assert not any(p.requires_grad for p in model.extractor.parameters())
    out = model({"audio": {"data": torch.zeros(2, 16000)}})["main"]
    assert out.shape == (2, 2) and out.requires_grad
