"""Port BatchNorm folding (utils/fold_bn.py, CNN1DExtractor(folded=True))
against the JAX package's, on the CPU.

The JAX extractor's BatchNorm statistics come from one train-mode pass, as
in tests/test_fold_bn.py; its weights reach the port through
io/from_jax.py.  The port's folded extractor is held to JAX's folded one at
tests/test_fold_bn.py:23-24 (atol 2e-4, rtol 1e-4) and to the port's own
unfolded eval forward.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.models.cnn1d import (
    CNN1DExtractor as JaxExtractor)
from multimodalaggressionrecognition_tpu.utils import fold_bn as jfold
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables, load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.models.cnn1d import (
    CNN1DExtractor)
from multimodalaggressionrecognition_tpu_torch.utils.fold_bn import (
    fold_cnn1d_variables, fold_conv_bn)


@pytest.fixture(scope="module")
def jax_trained():
    """(JAX variables with non-trivial BN statistics, the input)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 20000)) * 0.3).astype(np.float32)
    base = JaxExtractor(pallas_stem=False)
    variables = base.init(jax.random.PRNGKey(0), x)
    _, updates = base.apply(variables, x, train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
    variables = {"params": variables["params"],
                 "batch_stats": updates["batch_stats"]}
    return jax.tree.map(np.asarray, variables), x


def test_folded_extractor_matches_jax(jax_trained):
    variables, x = jax_trained
    folded_vars = jfold.fold_cnn1d_variables(variables, path=())
    want = JaxExtractor(folded=True, pallas_stem=False).apply(folded_vars, x)

    port = load_jax_variables(CNN1DExtractor(), variables).eval()
    folded = CNN1DExtractor(folded=True)
    folded.load_state_dict(fold_cnn1d_variables(port.state_dict()),
                           strict=True)
    folded.eval()
    with torch.inference_mode():
        got = folded(torch.from_numpy(x))
        unfolded = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), unfolded.numpy(), atol=2e-4,
                               rtol=1e-4)
    assert not any(k.startswith("bn") for k in folded.state_dict())


def test_fold_conv_bn_matches_jax(jax_trained):
    """One conv + BN: the port's folded weight and bias are the JAX ones
    through the bridge's layout, within f32 rounding."""
    variables, _ = jax_trained
    p, s = variables["params"], variables["batch_stats"]
    folded = dict(p, conv2=jfold.fold_conv_bn(p["conv2"], p["bn2"],
                                              s["bn2"]))
    want = from_jax_variables({"params": jax.tree.map(np.asarray, folded),
                               "batch_stats": s})
    port = from_jax_variables(variables)
    w, b = fold_conv_bn(port["conv2.weight"], port["conv2.bias"],
                        port["bn2.weight"], port["bn2.bias"],
                        port["bn2.running_mean"], port["bn2.running_var"])
    np.testing.assert_allclose(w.numpy(), want["conv2.weight"].numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), want["conv2.bias"].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_folded_is_inference_only():
    m = CNN1DExtractor(folded=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        m(torch.zeros((1, 16000)))
