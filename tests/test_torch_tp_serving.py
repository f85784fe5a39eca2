"""Tensor-parallel serving of the PyTorch port in one process (the JAX
package's `Predictor(sharding=, param_placement=place_params)` and
`serve --model_parallelism`), at tests/test_tp_cli.py's size: the
flagship at hidden 64, 16 000 samples, 12 tokens, b8.

- tp 2 over ["cpu", "cpu"] and dp 2 x tp 2 over ["cpu"] * 4 against the
  one-device port `Predictor`, atol 1e-5 (tests/test_tp_cli.py:179);
- the port's tp 2 against JAX's `Predictor` on the dp 4 x tp 2 virtual-CPU
  mesh, on the same weights, atol 1e-4 (tests/test_torch_serve.py);
- weight-only int8 under tp 2 against int8 on one device (1e-5), its
  codes split with their scales; w8a8 left whole; bf16 under tp 2 against
  bf16 on one device within 1e-2 of the largest logit;
- the `model_parallelism=2` daemon answering /score and /healthz
  (tests/test_tp_cli.py:239-273), and `ExportedPredictor` under tp scoring
  as the one-device artifact.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.parallel.mesh import (
    sum_partials)
from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
    Split, local_splits)
from multimodalaggressionrecognition_tpu_torch.serve import Predictor
from tests.test_torch_flagship import HIDDEN, SAMPLES, TOKENS, flagship_pair

SPLIT = {"fusion.encoder.layers.0.self_attn.in_proj_weight": Split(0, 3),
         "fusion.encoder.layers.0.self_attn.in_proj_bias": Split(0, 3),
         "fusion.encoder.layers.0.self_attn.out_proj.weight": Split(1),
         "fusion.encoder.layers.0.linear1.weight": Split(0),
         "fusion.encoder.layers.0.linear1.bias": Split(0),
         "fusion.encoder.layers.0.linear2.weight": Split(1)}


@pytest.fixture(scope="module")
def pair():
    return flagship_pair(seed=2)


def _request(seed, n):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((n, TOKENS, HIDDEN)).astype(np.float32)
    text[0, 5:] = 0.0  # zero-padded (masked) token rows
    return {"audio": (rng.standard_normal((n, SAMPLES)) * 0.1).astype(
                np.float32), "text": text}


def _predictor(pair, **kw):
    import copy

    return Predictor(copy.deepcopy(pair[2]), batch_size=8, device="cpu",
                     **kw).warmup(_request(0, 1))


def _logits(pred, req):
    return pred.predict(req, return_probs=False)


@pytest.fixture(scope="module")
def one(pair):
    return _predictor(pair)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_tp_matches_one_device(pair, one, n_devices):
    """tp 2 (one data group) and dp 2 x tp 2 (two groups, each its copy)."""
    tp = _predictor(pair, devices=["cpu"] * n_devices, model_parallelism=2)
    assert [len(g) for g in tp.groups] == [2] * (n_devices // 2)
    assert len(tp.replicas) == n_devices // 2
    for replica in tp.replicas:
        assert local_splits(replica.model) == SPLIT
    attn = tp.model.fusion.encoder.layers[0].self_attn
    assert attn.in_proj_weight is None  # the whole weight is freed
    assert [s.in_proj_weight.shape for s in attn.tp_shards] == [
        (3 * HIDDEN // 2, HIDDEN)] * 2
    for n in (8, 5, 1):  # padded all-masked rows in every batch but the full
        req = _request(n, n)
        want, got = one.predict(req), tp.predict(req)
        for head in want:
            assert got[head].shape == (n, 2)
            np.testing.assert_allclose(got[head], want[head], rtol=0,
                                       atol=1e-5)


def test_tp_matches_jax_dp4_tp2(pair):
    """The port's tp 2 against JAX's dp 4 x tp 2 Predictor on the 8 virtual
    CPU devices (`place_params` over `make_mesh`)."""
    import jax

    from multimodalaggressionrecognition_tpu.parallel import make_mesh
    from multimodalaggressionrecognition_tpu.parallel.mesh import (
        data_sharding)
    from multimodalaggressionrecognition_tpu.parallel.sharding_rules import (
        place_params)
    from multimodalaggressionrecognition_tpu.serve import (
        Predictor as JaxPredictor)

    jmodel, variables, _ = pair
    mesh = make_mesh(jax.devices(), data_axis="data", model_axis="model",
                     model_parallelism=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    jtp = JaxPredictor(jmodel, variables, batch_size=8,
                       sharding=data_sharding(mesh),
                       param_placement=lambda p: place_params(p, mesh))
    tp = _predictor(pair, devices=["cpu", "cpu"], model_parallelism=2)
    req = _request(11, 8)
    want, got = jtp.predict(req), tp.predict(req)
    assert sorted(got) == sorted(want)
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_tp_int8_splits_codes_with_their_scales(pair, n_devices):
    """The whole weight is quantized, then its int8 codes are split: a row
    split takes its rows' scales, a column split the whole scale.  Under
    dp 2 x tp 2 each group's deep copy is split on its own."""
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        shard_tensor)

    one8 = _predictor(pair, quantize="int8")
    tp8 = _predictor(pair, quantize="int8", devices=["cpu"] * n_devices,
                     model_parallelism=2)
    layer = "fusion.encoder.layers.0"
    for replica in tp8.replicas:
        assert local_splits(replica.model) == SPLIT
        for owner, attr in ((f"{layer}.self_attn", "in_proj_weight"),
                            (f"{layer}.self_attn", "out_proj.weight"),
                            (layer, "linear1.weight"),
                            (layer, "linear2.weight")):
            split = SPLIT[f"{owner}.{attr}"]
            mod, _, pname = f"{owner}.{attr}".rpartition(".")
            whole = one8.model.get_submodule(mod).parametrizations[pname]
            shards = replica.model.get_submodule(owner).tp_shards
            for rank, shard in enumerate(shards):
                piece = shard.parametrizations[attr.replace(".", "_")]
                assert piece.original.dtype == torch.int8
                assert torch.equal(piece.original, shard_tensor(
                    whole.original, split, rank, 2))
                scale = (shard_tensor(whole[0].scale, split, rank, 2)
                         if split.dim == 0 else whole[0].scale)
                assert torch.equal(piece[0].scale, scale)
    req = _request(3, 6)
    want, got = one8.predict(req), tp8.predict(req)
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-5)


def test_tp_w8a8_stays_whole(pair):
    """A column-split w8a8 input would change its per-row activation
    scales, so w8a8 serves the blocks whole under tp."""
    one = _predictor(pair, quantize="w8a8")
    tp = _predictor(pair, quantize="w8a8", devices=["cpu", "cpu"],
                    model_parallelism=2)
    assert local_splits(tp.model) == {}
    req = _request(4, 8)
    want, got = _logits(one, req), _logits(tp, req)
    for head in want:
        np.testing.assert_array_equal(got[head], want[head])


def test_tp_bf16_matches_one_bf16_device(pair):
    one16 = _predictor(pair, compute_dtype="bfloat16")
    tp16 = _predictor(pair, compute_dtype="bfloat16", devices=["cpu", "cpu"],
                      model_parallelism=2)
    req = _request(5, 7)
    want, got = _logits(one16, req), _logits(tp16, req)
    for head in want:
        scale = float(np.abs(want[head]).max())
        assert float(np.abs(got[head] - want[head]).max()) <= 1e-2 * scale


def test_sum_partials_sums_16_bit_in_f32():
    parts = [torch.tensor([1.0, 256.0], dtype=torch.bfloat16),
             torch.tensor([0.00390625, 1.0], dtype=torch.bfloat16),
             torch.tensor([0.00390625, 1.0], dtype=torch.bfloat16)]
    got = sum_partials(parts, torch.device("cpu"))
    assert got.dtype == torch.bfloat16
    # bf16 running sums would round 256 + 1 back to 256 twice
    want = sum(p.float() for p in parts).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert float(got[1]) == 258.0


def test_tp_must_divide_devices_and_batch(pair):
    with pytest.raises(ValueError, match="model_parallelism 2 does not "
                                         "divide the 3 available devices"):
        _predictor(pair, devices=["cpu"] * 3, model_parallelism=2)
    with pytest.raises(ValueError, match="model_parallelism 2 does not "
                                         "divide the 1 available devices"):
        _predictor(pair, model_parallelism=2)
    with pytest.raises(ValueError, match="batch_size 7 must divide across "
                                         "the 2 batch shards"):
        Predictor(pair[2], batch_size=7, devices=["cpu"] * 4,
                  model_parallelism=2)


def test_serve_daemon_model_parallelism(pair, one):
    from multimodalaggressionrecognition_tpu_torch.cli.serve import (
        ServeConfig, build_server)
    from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
        from_jax_variables)

    cfg = ServeConfig(modalities="audio,text", audio_samples=SAMPLES,
                      text_tokens=TOKENS, hidden_size=HIDDEN, fusion_heads=8,
                      batch_size=8, max_delay_ms=10.0, port=0, device="cpu",
                      model_parallelism=2)
    srv = build_server(cfg, state_dict=from_jax_variables(pair[1]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert [[str(d) for d in g] for g in srv.predictor.groups] == [
            ["cpu", "cpu"]]
        host, port = srv.server_address[:2]
        req = _request(6, 2)
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://{host}:{port}/score",
            data=json.dumps({k: v.tolist() for k, v in req.items()}).encode(),
            headers={"Content-Type": "application/json"}), timeout=120)
        out = json.loads(r.read())
        assert sorted(out) == ["phys", "verb"]
        want = one.predict(req)
        for head in want:  # the daemon rounds to 4 places
            np.testing.assert_allclose(out[head], want[head], atol=1e-4)
        health = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/healthz", timeout=30).read())
        assert health["ok"] and health["batch_size"] == 8
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_exported_predictor_under_tp(one, tmp_path):
    """Under tp the artifact is served on each data group's first device;
    on the CPU that is one group, so it scores as the one-device
    artifact."""
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ExportedPredictor, export_predictor)

    export_predictor(one, _request(0, 1), str(tmp_path / "art"))
    single = ExportedPredictor(str(tmp_path / "art"), device="cpu").warmup()
    tp = ExportedPredictor(str(tmp_path / "art"), devices=["cpu", "cpu"],
                           model_parallelism=2).warmup()
    assert [str(d) for d in tp.devices] == ["cpu"] and tp.batch_size == 8
    req = _request(7, 5)
    want, got = single.predict(req), tp.predict(req)
    for head in want:
        np.testing.assert_array_equal(got[head], want[head])
    with pytest.raises(ValueError, match="does not divide the 3 available"):
        ExportedPredictor(str(tmp_path / "art"), devices=["cpu"] * 3,
                          model_parallelism=2)
