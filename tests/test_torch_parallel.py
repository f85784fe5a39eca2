"""Data-parallel serving of the PyTorch port in one process (the JAX
package's `Predictor(sharding=)`, `ExportedPredictor(sharding=)` and
`serve --data_parallel`): replicas over ["cpu", "cpu"] against one device,
JAX's batch-divides check, `serve --data_parallel --device cpu` answering
/score, `serve --model_parallelism 2` serving one device's scores and
refusing a tp that does not divide the devices, and `doctor`'s launch
report.  Tensor-parallel serving's own tests are
test_torch_tp_serving.py.  The multi-rank training tests are
test_torch_parallel_{steps,cli,trainer}.py.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
    AUDIO_LEN, HIDDEN, TEXT_LEN, _flagship)
from multimodalaggressionrecognition_tpu_torch.serve import Predictor


def _request(seed, n):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((n, AUDIO_LEN)) * 0.1).astype(
                np.float32),
            "text": rng.standard_normal((n, TEXT_LEN, HIDDEN)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def predictors():
    one = Predictor(_flagship(), batch_size=8, device="cpu").warmup(
        _request(0, 1))
    two = Predictor(_flagship(), batch_size=8,
                    devices=["cpu", "cpu"]).warmup(_request(0, 1))
    return one, two


def test_predictor_replicas_match_one_device(predictors):
    one, two = predictors
    assert [str(d) for d in two.devices] == ["cpu", "cpu"]
    assert len(two.replicas) == 2 and two.replicas[1].model is not two.model
    assert two.heads == one.heads == ["phys", "verb"]
    for n in (8, 5, 1):  # a full batch, one spilling into the second replica
        req = _request(n, n)
        want, got = one.predict(req), two.predict(req)
        for head in want:
            assert got[head].shape == (n, 2)
            np.testing.assert_allclose(got[head], want[head], rtol=0,
                                       atol=1e-5)


def test_batch_must_divide_over_replicas():
    with pytest.raises(ValueError, match="batch_size 7 must divide across "
                                         "the 2 batch shards"):
        Predictor(_flagship(), batch_size=7, devices=["cpu", "cpu"])


def test_exported_predictor_replicas_match_one_device(predictors, tmp_path):
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ExportedPredictor, export_predictor)

    one, _ = predictors
    export_predictor(one, _request(0, 1), str(tmp_path / "art"))
    single = ExportedPredictor(str(tmp_path / "art"), device="cpu").warmup()
    pair = ExportedPredictor(str(tmp_path / "art"),
                             devices=["cpu", "cpu"]).warmup()
    # each replica scores the artifact's fixed batch of 8
    assert len(pair._modules) == 2 and pair.batch_size == 16
    req = _request(3, 12)
    got = pair.predict(req)
    want = {h: np.concatenate([single.predict(
        {k: v[s:s + 8] for k, v in req.items()})[h] for s in (0, 8)])
        for h in single.heads}
    live = one.predict({k: v[:8] for k, v in req.items()})
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[head][:8], live[head], rtol=0,
                                   atol=1e-5)


def _serve_config(**kw):
    from multimodalaggressionrecognition_tpu_torch.cli.serve import (
        ServeConfig)

    return ServeConfig(modalities="audio,text", audio_samples=AUDIO_LEN,
                       text_tokens=TEXT_LEN, hidden_size=HIDDEN,
                       batch_size=8, max_delay_ms=10.0, port=0,
                       allow_random_weights=True, device="cpu", **kw)


def _score(srv, body):
    host, port = srv.server_address[:2]
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://{host}:{port}/score", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=120)
    return json.loads(r.read())


@pytest.mark.parametrize("parallel", [False, True])
def test_serve_data_parallel_answers_score(parallel):
    from multimodalaggressionrecognition_tpu_torch.cli.serve import (
        build_server)

    srv = build_server(_serve_config(data_parallel=parallel))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert [str(d) for d in srv.predictor.devices] == (
            ["cpu"] if parallel else [])
        req = _request(5, 2)
        out = _score(srv, {k: v.tolist() for k, v in req.items()})
        assert sorted(out) == ["phys", "verb"]
        want = srv.predictor.predict(req)
        for head in out:
            np.testing.assert_allclose(out[head], want[head], atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=10)


def test_serve_model_parallelism_is_refused(predictors):
    """`serve --model_parallelism` is refused only where tp does not divide
    the devices (JAX's exit); tp 2 on the CPU holds both shards and serves
    one device's scores."""
    from multimodalaggressionrecognition_tpu_torch.cli.serve import (
        build_server)

    with pytest.raises(SystemExit, match="--model_parallelism 3 does not "
                                         "divide the 2 available devices"):
        build_server(_serve_config(model_parallelism=3),
                     devices=["cpu", "cpu"])
    one, _ = predictors
    srv = build_server(_serve_config(model_parallelism=2))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert [[str(d) for d in g] for g in srv.predictor.groups] == [
            ["cpu", "cpu"]]
        req = _request(7, 3)
        out = _score(srv, {k: v.tolist() for k, v in req.items()})
        want = one.predict(req)
        for head in want:  # the daemon rounds to 4 places
            np.testing.assert_allclose(out[head], want[head], atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=10)


def test_doctor_reports_the_launch(monkeypatch):
    from multimodalaggressionrecognition_tpu_torch.cli import doctor

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    report = doctor.collect()["distributed"]
    assert report["initialized"] is False
    assert (report["world_size"], report["rank"]) == (4, 2)
    assert report["backends"]["gloo"] is True
    assert report["env"] == {"RANK": "2", "WORLD_SIZE": "4",
                             "LOCAL_RANK": "2"}


def test_one_rank_group_step_matches_plain(tmp_path):
    """A world of one (an in-process store, gloo): the mesh's step with
    its all-reduces equals the plain step bit for bit."""
    import subprocess
    import sys

    from _torch_parallel_child import REPO

    code = (
        "import torch, numpy as np\n"
        "torch.set_num_threads(1)\n"
        "from multimodalaggressionrecognition_tpu_torch.parallel.mesh import ("
        "init_from_env, make_mesh)\n"
        "from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import ("
        "_step, _batch)\n"
        "init_from_env('cpu')\n"
        "a = _step(_batch(4), make_mesh(1, 'cpu'))\n"
        "b = _step(_batch(4), None)\n"
        "assert a == b, (a, b)\n"
        "print('ok', a)\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")
