"""Port serving artifacts (io/export.py, cli/export_model.py and
`--exported` in cli/serve.py, cli/predict.py, cli/evaluate.py) on the CPU,
mirroring tests/test_export.py.

- An artifact scores within 1e-6 of its live Predictor (f32, int8, w8a8;
  tests/test_export.py:48), padding invariant, behind a MicroBatcher and
  the daemon, for every one of the eight `--entry` models.
- Its graph keeps K1, K2 and K4 as `mar_torch::` ops (not their plain
  versions traced into aten ops).
- Co-resident named models route by `/score/<name>`; the daemon refuses
  mixed, duplicate and unnamed entries and `--exported` beside a
  checkpoint or `--quantize`; an artifact refuses a device outside its
  `platforms`; `--native true` (TPU-only in JAX) is refused.
- `predict --exported` (with the (T, D) feature-sequence video of a
  train_video_rnn artifact) and `evaluate --exported` give the same
  scores and metrics as the same CLIs on the checkpoint.
- The JAX package's artifact and the port's, on the same weights, agree
  at the flagship's parity tolerance (1e-4).

`test_export_data_parallel` (multi-GPU, ROADMAP item 10) and `force_xla`
(TPU-only) have no counterpart.
"""

import copy
import importlib
import json
import os
import threading
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu.io.export import (
    ExportedPredictor as JaxExportedPredictor)
from multimodalaggressionrecognition_tpu.io.export import (
    export_predictor as jax_export_predictor)
from multimodalaggressionrecognition_tpu.serve import Predictor as JaxPredictor
from multimodalaggressionrecognition_tpu_torch.cli import (evaluate,
                                                           export_model,
                                                           predict)
from multimodalaggressionrecognition_tpu_torch.cli.common import parse_config
from multimodalaggressionrecognition_tpu_torch.cli.serve import (
    ServeConfig, build_server)
from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
    save_variables)
from multimodalaggressionrecognition_tpu_torch.io.export import (
    ARTIFACT, ExportedPredictor, export_predictor, graph_ops)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.serve import (MicroBatcher,
                                                             Predictor)
from test_torch_flagship import HIDDEN, SAMPLES, TOKENS, flagship_pair


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def flagship():
    return flagship_pair(seed=4)


EXAMPLE = {"audio": np.zeros((1, SAMPLES), np.float32),
           "text": np.zeros((1, TOKENS, HIDDEN), np.float32)}


def _predictor(port, batch_size=4, quantize=None):
    pred = Predictor(copy.deepcopy(port), batch_size=batch_size,
                     device="cpu", quantize=quantize)
    return pred.warmup(EXAMPLE)


def _request(seed, n=3):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((n, SAMPLES)) * 0.1).astype(
                np.float32),
            "text": rng.standard_normal((n, TOKENS, HIDDEN)).astype(
                np.float32)}


@pytest.mark.parametrize("quantize", [None, "int8", "w8a8"])
def test_export_roundtrip_parity(flagship, quantize, tmp_path):
    pred = _predictor(flagship[2], quantize=quantize)
    meta = export_predictor(pred, EXAMPLE, str(tmp_path / "art"))
    assert meta["format"] == "mar-torch-export-v1"
    assert meta["heads"] == {"phys": 2, "verb": 2}
    exported = ExportedPredictor(str(tmp_path / "art"), device="cpu")
    assert exported.batch_size == pred.batch_size == 4
    assert exported.modalities == ["audio", "text"]
    assert exported.clip_shapes["audio"] == (SAMPLES,)
    req = _request(1)
    want = pred.predict(req)
    got = exported.predict(req)
    for head in want:
        np.testing.assert_allclose(got[head], want[head], atol=1e-6)
    # padding invariance holds through the artifact too
    one = exported.predict({k: v[:1] for k, v in req.items()})
    np.testing.assert_allclose(one["verb"][0], want["verb"][0], atol=1e-6)
    # the program checks its inputs in the traced order, whatever the
    # caller's (the micro-batcher merges a request by a set)
    reordered = exported.predict(dict(reversed(list(req.items()))))
    for head in want:
        np.testing.assert_allclose(reordered[head], want[head], atol=1e-6)


def test_export_int8_artifact_is_smaller(flagship, tmp_path):
    """int8 weights are baked in as int8: under half the f32 artifact."""
    for quantize in (None, "int8"):
        export_predictor(_predictor(flagship[2], quantize=quantize), EXAMPLE,
                         str(tmp_path / str(quantize)))
    size = {k: os.path.getsize(str(tmp_path / k / ARTIFACT))
            for k in ("None", "int8")}
    assert size["int8"] < 0.5 * size["None"], size


def test_exported_predictor_behind_microbatcher(flagship, tmp_path):
    pred = _predictor(flagship[2])
    export_predictor(pred, EXAMPLE, str(tmp_path / "art"))
    exported = ExportedPredictor(str(tmp_path / "art"), device="cpu")
    req = _request(2, n=2)
    want = pred.predict(req)
    mb = MicroBatcher(exported, max_delay_ms=20.0)
    try:
        futs = [mb.submit({k: v[i:i + 1] for k, v in req.items()})
                for i in range(2)]
        for i, f in enumerate(futs):
            got = f.result(timeout=60)
            assert got["verb"].shape == (1, 2)
            np.testing.assert_allclose(got["verb"][0], want["verb"][i],
                                       atol=1e-6)
    finally:
        mb.close()


def test_export_cli_and_serve_exported(tmp_path):
    """cli.export_model writes the artifact; cli.serve --exported builds
    the daemon from its meta alone (modalities, clip shapes, batch)."""
    out = str(tmp_path / "artifact")
    meta = export_model.main([
        "--allow_random_weights", "true", "--modalities", "audio,text",
        "--hidden_size", "64", "--fusion_heads", "4", "--audio_samples",
        "16000", "--text_tokens", "8", "--batch_size", "4", "--platforms",
        "cpu", "--device", "cpu", "--output_dir", out])
    assert meta["platforms"] == ["cpu"]
    assert os.path.isfile(os.path.join(out, ARTIFACT))
    assert os.path.isfile(os.path.join(out, "meta.json"))
    # every shape comes from the artifact: the config's shape flags stay at
    # their defaults and must not matter
    srv = build_server(ServeConfig(exported=out, port=0, device="cpu"))
    try:
        assert srv.endpoint.modalities == {"audio", "text"}
        assert srv.endpoint.batch_size == 4
        assert sorted(srv.endpoint.heads) == ["phys", "verb"]
        # pads from the artifact's clip shapes (16000 / 8), not the
        # ServeConfig defaults (80000 / 48)
        pads = srv.endpoint.pads
        assert pads["audio"](np.zeros(999, np.float32)).shape == (16000,)
        assert pads["text"](np.zeros((3, 64), np.float32)).shape == (8, 64)
        scores = srv.batcher.submit(
            {"audio": np.zeros((1, 16000), np.float32),
             "text": np.zeros((1, 8, 64), np.float32)}).result(timeout=60)
        assert scores["verb"].shape == (1, 2)
    finally:
        srv.server_close()
        srv.batcher.close()


# (entry, its config flags, export flags): small widths; the heavy towers
# (Swin3D-T, R3D-18) export quantized, which also puts int8 and w8a8 on
# those paths, and the audio RNN over CNN1D exports int8 GRU and LSTM
ENTRIES = [
    ("train_multimodal", ["--modalities", "audio,text", "--hidden_size", "64",
                          "--fusion_heads", "4", "--audio_samples", "16000",
                          "--text_tokens", "8"], []),
    ("train_text_transformer", ["--num_layers", "1", "--text_tokens", "8",
                                "--hidden_size", "64", "--num_heads", "4"],
     []),
    ("train_audio_rnn", ["--extractor", "cnn1d", "--audio_seconds", "1",
                         "--hidden_size", "32"], ["--quantize", "int8"]),
    ("train_audio_transformer", ["--arch", "transformer", "--audio_seconds",
                                 "1"], []),
    ("train_video_transformer", ["--video_frames", "8", "--video_size", "32",
                                 "--video_window", "4", "--num_layers", "1"],
     ["--quantize", "int8"]),
    ("train_video_rnn", ["--feature_dim", "32", "--hidden_size", "32",
                         "--sequence_len", "5"], []),
    ("train_audio_text", ["--audio_samples", "16000", "--text_tokens", "8",
                          "--hidden_size", "64"], []),
    ("train3dcnn", ["--frame_num", "8", "--video_size", "32"],
     ["--quantize", "w8a8"]),
]


def _live(entry, flags, quantize, compute_dtype=None):
    """The entry's model, seeded as export_model seeds it, in a live
    Predictor; and a request shaped by its export spec."""
    mod = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{entry}")
    cfg = parse_config(export_model._entry_config_cls(mod),
                       flags + ["--batch_size", "2", "--device", "cpu"])
    model, spec = export_model._build_model_and_spec(mod, cfg)
    pred = Predictor(seeded_init_(model, cfg.seed), batch_size=2,
                     device="cpu", quantize=quantize,
                     compute_dtype=compute_dtype)
    rng = np.random.default_rng(5)
    request = {m: rng.standard_normal((2, *s)).astype(np.float32) * 0.3
               for m, s in spec.items()}
    return pred, request


@pytest.mark.parametrize("entry,flags,export_flags", ENTRIES,
                         ids=[e[0] for e in ENTRIES])
def test_export_entry_families(entry, flags, export_flags, tmp_path):
    """--entry exports any train CLI's model, and its artifact scores
    within 1e-6 of the same model's live Predictor."""
    out = str(tmp_path / "art")
    meta = export_model.main(
        ["--entry", entry, "--allow_random_weights", "true", *flags,
         *export_flags, "--batch_size", "2", "--device", "cpu",
         "--output_dir", out])
    quantize = export_flags[1] if export_flags else None
    pred, request = _live(entry, flags, quantize)
    exported = ExportedPredictor(out, device="cpu")
    assert exported.modalities == sorted(request)
    assert meta["clip_shapes"] == {m: list(v.shape[1:])
                                   for m, v in request.items()}
    want = pred.predict(request)
    got = exported.predict(request)
    assert sorted(got) == sorted(want) == exported.heads
    for head in want:
        assert got[head].shape == (2, meta["heads"][head])
        np.testing.assert_allclose(got[head], want[head], atol=1e-6)


@pytest.mark.parametrize("entry,flags", [e[:2] for e in ENTRIES],
                         ids=[e[0] for e in ENTRIES])
def test_export_entry_families_bf16(entry, flags, tmp_path):
    """--compute_dtype bfloat16 exports any train CLI's model, and its
    artifact scores within 1e-6 of the same model's live bf16 Predictor."""
    out = str(tmp_path / "art")
    export_model.main(
        ["--entry", entry, "--allow_random_weights", "true", *flags,
         "--compute_dtype", "bfloat16", "--batch_size", "2", "--device",
         "cpu", "--output_dir", out])
    pred, request = _live(entry, flags, None, "bfloat16")
    want = pred.predict(request)
    got = ExportedPredictor(out, device="cpu").predict(request)
    assert sorted(got) == sorted(want)
    for head in want:
        assert got[head].dtype == want[head].dtype == np.float32
        assert np.isfinite(got[head]).all()
        np.testing.assert_allclose(got[head], want[head], atol=1e-6)


def test_serve_feature_sequence_artifact(tmp_path):
    """A (T, D) feature-sequence "video" (train_video_rnn) over HTTP: 3
    tokens padded to the artifact's 5 by the daemon."""
    out = str(tmp_path / "rnn")
    export_model.main(["--entry", "train_video_rnn", "--allow_random_weights",
                       "true", "--feature_dim", "32", "--hidden_size", "32",
                       "--sequence_len", "5", "--batch_size", "2",
                       "--device", "cpu", "--output_dir", out])
    srv = build_server(ServeConfig(exported=out, port=0, device="cpu",
                                   max_delay_ms=5.0))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert srv.endpoint.modalities == {"video"}
        scores = _post(srv, "/score",
                       {"video": np.zeros((3, 32)).tolist()})
        assert set(scores) == {"LSTM_1_layer", "GRU_1_layer", "Avg"}
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=10)


def _post(srv, path, body):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_multi_model_routing(flagship, tmp_path):
    """One daemon hosting two artifacts (f32 and int8): /score/<name>
    routes, /score 404s naming the models, healthz lists both."""
    for name, quantize in (("a", None), ("b", "int8")):
        export_predictor(_predictor(flagship[2], quantize=quantize), EXAMPLE,
                         str(tmp_path / name))
    srv = build_server(ServeConfig(
        exported=f"a={tmp_path / 'a'},b={tmp_path / 'b'}", port=0,
        device="cpu", max_delay_ms=5.0))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert set(health["models"]) == {"a", "b"}
        body = {"audio": np.zeros(SAMPLES).tolist(),
                "text": np.zeros((TOKENS, HIDDEN)).tolist()}
        for name in ("a", "b"):
            assert len(_post(srv, f"/score/{name}", body)["verb"][0]) == 2
        with urllib.request.urlopen(f"http://{host}:{port}/statz",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["a"]["requests"] == stats["b"]["requests"] == 1
        for path in ("/score", "/score/zzz"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv, path, body)
            assert err.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        for ep in srv.endpoints.values():
            ep.batcher.close()
        thread.join(timeout=10)
    assert all(ep.batcher._closed for ep in srv.endpoints.values())


@pytest.mark.parametrize("exported,extra,match", [
    ("a=x,y", {}, "mixing named"),
    ("a=x,a=y", {}, "duplicate model names"),
    ("x,y", {}, "need names"),
    ("x", {"path_to_checkpoint": "ckpt"}, "conflicts"),
    ("x", {"quantize": "int8"}, "conflicts"),
], ids=["mixed", "duplicate", "unnamed", "checkpoint", "quantize"])
def test_serve_exported_rejections(exported, extra, match):
    with pytest.raises(SystemExit, match=match):
        build_server(ServeConfig(exported=exported, port=0, device="cpu",
                                 **extra))


def test_exported_rejects_wrong_platform(flagship, tmp_path):
    export_predictor(_predictor(flagship[2]), EXAMPLE, str(tmp_path / "art"),
                     platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        ExportedPredictor(str(tmp_path / "art"), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_predictor(_predictor(flagship[2]), EXAMPLE,
                         str(tmp_path / "bad"), platforms=("cpu", "tpu"))


def test_export_native_refused(tmp_path):
    """JAX's --native keeps Mosaic kernels and is TPU-only; the port's
    artifact always keeps its own, so the flag is refused."""
    with pytest.raises(SystemExit, match="TPU-only"):
        export_model.main(["--native", "true", "--allow_random_weights",
                           "true", "--device", "cpu", "--output_dir",
                           str(tmp_path / "art")])


def test_exported_graph_holds_the_kernel_ops(tmp_path):
    """The tri-modal artifact calls K1, K2 and K4 as mar_torch:: ops: once,
    12 times (one per Swin block) and twice (stage 0's shifted block at
    32 px, forward and back), as many as the live forward launches."""
    from test_torch_trimodal import MODALITIES, SIZES, batch

    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_multimodal)

    model = train_multimodal.build_model(
        train_multimodal.MultimodalConfig(**SIZES), MODALITIES)
    pred = Predictor(seeded_init_(model, 0), batch_size=2, device="cpu")
    example = {m: d["data"][:1] for m, d in batch(1).items()}
    export_predictor(pred, example, str(tmp_path / "tri"))
    exported = ExportedPredictor(str(tmp_path / "tri"), device="cpu")
    calls = Counter(n.target.name() for n in exported.program.graph.nodes
                    if n.op == "call_function"
                    and hasattr(n.target, "name"))
    assert calls["mar_torch::framed_conv1d"] == 1
    assert calls["mar_torch::window_attention"] == 12
    assert calls["mar_torch::roll"] == 2
    assert not {"aten::roll", "aten::_softmax"} & graph_ops(exported.program)
    request = {m: d["data"] for m, d in batch(2).items()}
    want = pred.predict(request)
    got = exported.predict(request)
    for head in want:
        np.testing.assert_allclose(got[head], want[head], atol=1e-6)


def test_cpu_artifact_moves_off_the_cpu(flagship, tmp_path):
    """The device the export traced on is baked into the program; the
    move pass (which ExportedPredictor applies on another device) leaves
    no node, weight or constant on it.  On the CPU the target is the meta
    device; tests/test_torch_cuda.py moves to the card."""
    from torch.export.passes import move_to_device_pass

    export_predictor(_predictor(flagship[2], quantize="w8a8"), EXAMPLE,
                     str(tmp_path / "art"))
    program = ExportedPredictor(str(tmp_path / "art"), device="cpu").program
    assert any(str(n.kwargs.get("device")) == "cpu"
               for n in program.graph.nodes)
    moved = move_to_device_pass(program, "meta")
    assert not [n for n in moved.graph.nodes
                if str(n.kwargs.get("device", "meta")) == "cpu"]
    tensors = list(moved.state_dict.values()) + list(
        moved.constants.values())
    assert tensors and all(t.device.type == "meta" for t in tensors
                           if isinstance(t, torch.Tensor))


@pytest.fixture(scope="module")
def scored(flagship, tmp_path_factory):
    """A checkpoint of the flagship's weights and its artifact."""
    tmp = tmp_path_factory.mktemp("scored")
    ckpt = str(tmp / "ckpt")
    save_variables(ckpt, flagship[2].state_dict())
    art = str(tmp / "art")
    export_model.main(["--path_to_checkpoint", ckpt, "--modalities",
                       "audio,text", "--hidden_size", str(HIDDEN),
                       "--audio_samples", str(SAMPLES), "--text_tokens",
                       str(TOKENS), "--batch_size", "4", "--device", "cpu",
                       "--output_dir", art])
    return tmp, ckpt, art


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_predict_exported_matches_the_checkpoint(scored, capsys):
    tmp, ckpt, art = scored
    rng = np.random.default_rng(6)
    for m in ("audio", "text"):
        os.makedirs(tmp / m, exist_ok=True)
    for i in range(3):
        torch.save(torch.from_numpy(
            (rng.standard_normal(SAMPLES) * 0.1).astype(np.float32)),
            str(tmp / "audio" / f"c{i}.pt"))
        np.save(str(tmp / "text" / f"c{i}.npy"),
                rng.standard_normal((TOKENS - 2, HIDDEN)).astype(np.float32))
    files = ["--audio", str(tmp / "audio"), "--text", str(tmp / "text"),
             "--device", "cpu"]
    capsys.readouterr()
    predict.main(files + ["--exported", art])
    got = _lines(capsys)
    predict.main(files + ["--path_to_checkpoint", ckpt, "--hidden_size",
                          str(HIDDEN), "--audio_samples", str(SAMPLES),
                          "--text_tokens", str(TOKENS)])
    want = _lines(capsys)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g == w
    with pytest.raises(SystemExit, match="fixed input signature"):
        predict.main(["--audio", str(tmp / "audio"), "--device", "cpu",
                      "--exported", art])


def test_predict_exported_feature_sequences(tmp_path, capsys):
    """predict --exported on a train_video_rnn artifact takes (T, D) video
    features (.npy), padded to the artifact's sequence length."""
    out = str(tmp_path / "rnn")
    export_model.main(["--entry", "train_video_rnn", "--allow_random_weights",
                       "true", "--feature_dim", "32", "--hidden_size", "32",
                       "--sequence_len", "5", "--batch_size", "2",
                       "--device", "cpu", "--output_dir", out])
    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((n, 32)).astype(np.float32)
             for n in (3, 7)]
    os.makedirs(tmp_path / "v")
    for i, f in enumerate(feats):
        np.save(str(tmp_path / "v" / f"clip{i}.npy"), f)
    capsys.readouterr()
    predict.main(["--exported", out, "--video", str(tmp_path / "v"),
                  "--device", "cpu"])
    rows = _lines(capsys)
    padded = np.stack([np.pad(f, ((0, 2), (0, 0))) if len(f) < 5
                       else f[:5] for f in feats])
    want = ExportedPredictor(out, device="cpu").predict({"video": padded})
    assert [r["clip"] for r in rows] == ["clip0.npy", "clip1.npy"]
    for i, row in enumerate(rows):
        for head, p in want.items():
            assert row[f"{head}_prob_aggr"] == round(float(p[i, 1]), 4)
    np.save(str(tmp_path / "v" / "clip0.npy"), np.zeros((3, 31)))
    with pytest.raises(SystemExit, match="feature"):
        predict.main(["--exported", out, "--video", str(tmp_path / "v"),
                      "--device", "cpu"])


def test_evaluate_exported_matches_the_checkpoint(scored, tmp_path):
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    _, ckpt, art = scored
    root = str(tmp_path / "avabos")
    generate_synthetic_avabos(root, num_clusters=2, samples_per_cluster=4,
                              seed=9, audio_len=SAMPLES, text_len=TOKENS,
                              text_dim=HIDDEN)
    base = ["--dataset_root", root, "--modalities", "audio,text",
            "--device", "cpu", "--saving_dir", str(tmp_path / "runs")]
    got = evaluate.main(base + ["--exported", art])
    want = evaluate.main(base + [
        "--path_to_checkpoint", ckpt, "--hidden_size", str(HIDDEN),
        "--audio_samples", str(SAMPLES), "--text_tokens", str(TOKENS),
        "--batch_size", "4"])
    assert sorted(got) == sorted(want) and got
    for head in want:
        for metric in ("accuracy", "UAR", "UAP", "UAF1"):
            assert got[head][metric] == pytest.approx(want[head][metric],
                                                      abs=1e-12)
        assert "loss" not in got[head]


def test_jax_and_port_artifacts_agree(flagship, tmp_path):
    """The JAX package's artifact and the port's, exported from the same
    weights, score alike (1e-4, the flagship's parity bound)."""
    jmodel, variables, port = flagship
    jpred = JaxPredictor(jmodel, variables, batch_size=4)
    jpred.warmup(EXAMPLE)
    jax_export_predictor(jpred, EXAMPLE, str(tmp_path / "jax"),
                         platforms=("cpu",))
    export_predictor(_predictor(port), EXAMPLE, str(tmp_path / "port"))
    req = _request(9)
    want = JaxExportedPredictor(str(tmp_path / "jax")).predict(req)
    got = ExportedPredictor(str(tmp_path / "port"), device="cpu").predict(
        req)
    for head in want:
        np.testing.assert_allclose(got[head], want[head], atol=1e-4)
    # neither package takes the other's artifact
    with pytest.raises(ValueError, match="mar-torch-export-v1"):
        ExportedPredictor(str(tmp_path / "jax"), device="cpu")
