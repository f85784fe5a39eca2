"""Port serving (serve.py, cli/serve.py) on the CPU.

`Predictor` and `MicroBatcher` probabilities are held to the JAX package's
`serve.Predictor` on the same weights (1e-4, the flagship logit bound);
the rest mirrors tests/test_serve.py and tests/test_serve_cli.py on
`build_server(ServeConfig(device="cpu", port=0))`.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from multimodalaggressionrecognition_tpu.serve import (
    Predictor as JaxPredictor)
from multimodalaggressionrecognition_tpu_torch.cli.serve import (
    ServeConfig, build_server)
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    from_jax_variables)
from multimodalaggressionrecognition_tpu_torch.serve import (MicroBatcher,
                                                             Predictor)
from tests.test_torch_flagship import HIDDEN, SAMPLES, TOKENS, flagship_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return flagship_pair(seed=1)


def _request(seed, n):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((n, SAMPLES)) * 0.1).astype(
                np.float32),
            "text": rng.standard_normal((n, TOKENS, HIDDEN)).astype(
                np.float32)}


def _predictor(port, batch_size=4):
    return Predictor(port, batch_size=batch_size, device="cpu").warmup(
        _request(0, 1))


def test_predictor_matches_jax_predictor(pair):
    jmodel, variables, port = pair
    req = _request(1, 3)
    want = JaxPredictor(jmodel, variables, batch_size=4).predict(req)
    pred = _predictor(port)
    got = pred.predict(req)
    assert pred.heads == ["phys", "verb"]
    assert pred.modalities == ["audio", "text"]
    for head in want:
        assert got[head].shape == (3, 2)
        np.testing.assert_allclose(got[head], want[head], atol=1e-4)
        np.testing.assert_allclose(got[head].sum(1), 1.0, atol=1e-5)
    # padding must not change real rows' scores
    one = pred.predict({k: v[:1] for k, v in req.items()})
    np.testing.assert_allclose(one["verb"][0], got["verb"][0], atol=1e-5)
    with pytest.raises(ValueError, match="request batch 5"):
        pred.predict(_request(2, 5))


def test_microbatcher_coalesces_and_matches_jax(pair):
    jmodel, variables, port = pair
    clips = _request(3, 6)
    want = JaxPredictor(jmodel, variables, batch_size=8).predict(clips)
    mb = MicroBatcher(_predictor(port, batch_size=8), max_delay_ms=50.0)
    try:
        futs = [mb.submit({k: v[i:i + 1] for k, v in clips.items()})
                for i in range(6)]
        for i, f in enumerate(futs):
            got = f.result(timeout=30)
            for head in want:
                np.testing.assert_allclose(got[head][0], want[head][i],
                                           atol=1e-4)
        assert mb.stats["clips"] == 6 and mb.stats["dispatches"] < 6
    finally:
        mb.close()


def test_microbatcher_bad_request_fails_only_itself(pair):
    good = _request(4, 1)
    mb = MicroBatcher(_predictor(pair[2]), max_delay_ms=20.0)
    try:
        f_bad0 = mb.submit({"audio": good["audio"]})  # missing modality
        f_good = mb.submit(good)
        f_bad = mb.submit({"audio": good["audio"]})
        for f in (f_bad0, f_bad):
            with pytest.raises(ValueError, match="presence pattern"):
                f.result(timeout=30)
        assert f_good.result(timeout=30)["verb"].shape == (1, 2)
        with pytest.raises(ValueError, match="disagree on batch size"):
            mb.submit({"audio": np.zeros((2, SAMPLES), np.float32),
                       "text": good["text"]})
    finally:
        mb.close()


def test_microbatcher_counts_failures_and_close_drains(pair):
    pred = _predictor(pair[2])
    good = _request(5, 1)
    mb = MicroBatcher(pred, max_delay_ms=1000.0)  # long window: close first
    futs = [mb.submit(good) for _ in range(7)]  # spans two groups at cap 4
    mb.close()
    for f in futs:
        assert f.result(timeout=1)["verb"].shape == (1, 2)
    with pytest.raises(RuntimeError):
        mb.submit(good)

    pred.predict = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("device fell over"))
    mb = MicroBatcher(pred, max_delay_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="fell over"):
            mb.submit(good).result(timeout=30)
        assert mb.stats["failed_requests"] == 1
        assert mb.stats["dispatches"] == 0
    finally:
        mb.close()


# ------------------------------------------------------------ HTTP server

@pytest.fixture(scope="module")
def server(pair):
    cfg = ServeConfig(modalities="audio,text", hidden_size=HIDDEN,
                      fusion_heads=8, audio_samples=SAMPLES,
                      text_tokens=TOKENS, batch_size=4, max_delay_ms=30.0,
                      port=0, device="cpu")
    srv = build_server(cfg, state_dict=from_jax_variables(pair[1]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()  # join handlers while the batcher is still alive
    srv.batcher.close()
    thread.join(timeout=10)


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(srv, body, ctype="application/json", path="/score"):
    req = urllib.request.Request(_url(srv, path), data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return json.loads(r.read())


def test_healthz_and_statz(server):
    info = {"modalities": ["audio", "text"], "heads": ["phys", "verb"],
            "batch_size": 4}
    assert _get(server, "/healthz") == {"ok": True, "models": {"model": info},
                                        **info}
    before = _get(server, "/statz")["model"]["dispatches"]
    body = json.dumps({"audio": np.zeros(SAMPLES).tolist(),
                       "text": np.zeros((TOKENS, HIDDEN)).tolist()}).encode()
    for _ in range(3):
        assert _post(server, body)[0] == 200
    stats = _get(server, "/statz")["model"]
    assert stats["requests"] >= 3 and stats["clips"] >= 3
    assert stats["dispatches"] > before
    assert stats["mean_group_size"] >= 1.0
    assert stats["recent_latency_ms"]["p50"] > 0


def test_score_single_clip_json_pads_variable_lengths(server, pair):
    jmodel, variables, _ = pair
    audio = [0.1] * 1000                 # padded to SAMPLES
    text = [[0.2] * HIDDEN] * 3          # padded to TOKENS
    code, got = _post(server, json.dumps({"audio": audio,
                                          "text": text}).encode())
    assert code == 200
    padded = {"audio": np.pad(np.float32(audio), (0, SAMPLES - 1000))[None],
              "text": np.pad(np.float32(text), ((0, TOKENS - 3), (0, 0)))[None]}
    want = JaxPredictor(jmodel, variables, batch_size=4).predict(padded)
    for head in ("phys", "verb"):
        (row,) = got[head]
        assert abs(sum(row) - 1.0) < 1e-2  # softmax row, rounded to 4 dp
        np.testing.assert_allclose(row, want[head][0], atol=1e-3)


def test_score_npz_batch_chunks_and_matches_predictor(server):
    req = _request(6, 9)
    buf = io.BytesIO()
    np.savez(buf, **req)
    code, got = _post(server, buf.getvalue(), ctype="application/x-npz")
    assert code == 200
    assert len(got["verb"]) == 9  # 9 clips through batch-4 chunks
    direct = [server.predictor.predict({k: v[s:s + 4] for k, v in req.items()})
              for s in range(0, 9, 4)]
    want = np.concatenate([d["verb"] for d in direct])
    np.testing.assert_allclose(np.asarray(got["verb"]), want, atol=1e-3)


def test_concurrent_requests_coalesce_and_match(server):
    req = _request(7, 4)
    direct = server.predictor.predict(req)
    results = {}

    def hit(i):
        results[i] = _post(server, json.dumps(
            {k: v[i].tolist() for k, v in req.items()}).encode())

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(4):
        code, got = results[i]
        assert code == 200
        np.testing.assert_allclose(got["verb"][0], direct["verb"][i],
                                   atol=1e-3)


def test_bad_requests_get_400(server):
    code, got = _post(server, json.dumps({"audio": [0.0] * 100}).encode())
    assert code == 400 and "presence pattern" in got["error"]
    code, got = _post(server, json.dumps(
        {"audio": [[[0.0] * 4] * 4] * 4,
         "text": [[0.0] * HIDDEN] * 3}).encode())
    assert code == 400 and "audio" in got["error"]
    code, got = _post(server, json.dumps(
        {"audio": [[0.1] * 100] * 2,
         "text": [[[0.2] * HIDDEN] * 3] * 3}).encode())
    assert code == 400 and "disagree" in got["error"]
    code, got = _post(server, b"{not json")
    assert code == 400
    assert _post(server, b"{}", path="/nope")[0] == 404


def test_sigterm_drains_and_exits_cleanly():
    """cli.serve main() on --device cpu: SIGTERM stops accepting, drains,
    exits 0."""
    child = subprocess.Popen(
        [sys.executable, "-u", "-m",
         "multimodalaggressionrecognition_tpu_torch.cli.serve",
         "--modalities", "audio,text", "--hidden_size", "32",
         "--fusion_heads", "4", "--audio_samples", "16000",
         "--text_tokens", "4", "--batch_size", "2", "--port", "0",
         "--device", "cpu", "--allow_random_weights", "true"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        port = None
        while time.time() < deadline:
            line = child.stdout.readline()
            if line == "" and child.poll() is not None:
                break  # child died: fall through to the assert
            if '"serving"' in line:
                port = int(json.loads(line)["serving"].rsplit(":", 1)[1])
                break
        assert port, f"server never came up (rc={child.poll()})"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, out[-2000:]
    assert '"draining"' in out
