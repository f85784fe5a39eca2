"""The port's trainer end to end on the CPU: its data path against the JAX
package's, and `cli.train_multimodal.main` fine-tuning the tri-modal model
(--video_freeze false) at tiny sizes, resuming, and serving its best
checkpoint through the CPU HTTP server.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalaggressionrecognition_tpu.data import (
    AggrBatchSampler as JaxSampler, MultimodalSource as JaxSource,
    generate_synthetic_avabos as jax_generate)
from multimodalaggressionrecognition_tpu.data.pipeline import (
    BatchLoader as JaxLoader)
from multimodalaggressionrecognition_tpu.data.transforms import (
    pad_audio as jax_pad_audio, pad_video as jax_pad_video)
from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
from multimodalaggressionrecognition_tpu_torch.cli.serve import (
    ServeConfig, build_server)
from multimodalaggressionrecognition_tpu_torch.data.avabos import (
    MultimodalSource)
from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
    BatchLoader, device_prefetch)
from multimodalaggressionrecognition_tpu_torch.data.sampler import (
    AggrBatchSampler)
from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
    generate_synthetic_avabos)
from multimodalaggressionrecognition_tpu_torch.data.transforms import (
    pad_audio, pad_video)

FIXTURE = dict(num_clusters=3, samples_per_cluster=5, seed=7,
               audio_len=16000, text_len=8, video_frames=16, video_hw=32)
SIZES = dict(audio_samples=16000, text_tokens=8, video_frames=16,
             video_size=32, video_window=8)
MODALITIES = ("audio", "text", "video")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    and torch's CPU kernels slow down badly when they oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_data_path_gives_the_jax_batches(tmp_path):
    """Same seed: the same files and table, the same batches in the same
    order, array for array."""
    jax_generate(str(tmp_path / "jax"), **FIXTURE)
    generate_synthetic_avabos(str(tmp_path / "port"), **FIXTURE)
    dfs = [pd.read_csv(tmp_path / d / "time_intervals.csv")
           for d in ("jax", "port")]
    pd.testing.assert_frame_equal(*dfs)

    def loader(root, source, sampler, loader_cls, pads, threads):
        transforms = {"audio": pads[0](20000), "video": pads[1](24)}
        src = source(dfs[0], str(root), MODALITIES, transforms=transforms)
        smp = sampler(dfs[0]["aggr_type"].to_numpy(), 4, shuffle=True,
                      seed=3)
        smp.set_epoch(2)
        return loader_cls(src, smp, pad_to=4, num_threads=threads)

    want = list(loader(tmp_path / "jax", JaxSource, JaxSampler, JaxLoader,
                       (jax_pad_audio, jax_pad_video), 1))
    got = list(loader(tmp_path / "port", MultimodalSource, AggrBatchSampler,
                      BatchLoader, (pad_audio, pad_video), 3))
    assert len(got) == len(want) >= 5
    for g, w in zip(got, want):
        gf, wf = dict(_flat(g)), dict(_flat(w))
        assert sorted(gf) == sorted(wf)
        for k in wf:
            assert gf[k].dtype == wf[k].dtype, k
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    on_cpu = next(device_prefetch(iter(got), "cpu"))
    assert torch.equal(on_cpu["modalities"]["audio"]["data"],
                       torch.from_numpy(got[0]["modalities"]["audio"]["data"]))


def _args(tmp_path, epochs, *extra):
    args = ["--dataset_root", str(tmp_path / "ds"), "--synthetic",
            "--saving_dir", str(tmp_path / "runs"), "--run_name", "r",
            "--modalities", ",".join(MODALITIES), "--video_freeze", "false",
            "--epoch_num", str(epochs), "--batch_size", "4",
            "--num_threads", "2", "--log_console", "false",
            "--device", "cpu"]
    for k, v in SIZES.items():
        args += [f"--{k}", str(v)]
    return args + list(extra)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs from scratch, then a resumed third."""
    tmp = tmp_path_factory.mktemp("trainer")
    first = train_multimodal.main(_args(tmp, 2))
    logs = {f: pd.read_csv(os.path.join(first.run_dir, f))
            for f in os.listdir(first.run_dir) if f.endswith("_log.csv")}
    resumed = train_multimodal.main(_args(
        tmp, 3, "--resume_training", "--path_to_checkpoint",
        os.path.join(first.run_dir, "checkpoint_current")))
    return tmp, first, logs, resumed


def test_cli_fine_tunes_and_writes_logs_and_checkpoints(run):
    _, first, logs, _ = run
    files = set(os.listdir(first.run_dir))
    assert {"checkpoint_current", "checkpoint_best_phys",
            "checkpoint_best_verb", "config.json"} <= files
    assert sorted(logs) == sorted(f"{h}_{s}_log.csv" for h in ("phys", "verb")
                                  for s in ("train", "test"))
    for name, df in logs.items():
        assert df["epoch"].tolist() == [0, 1], name
        assert np.isfinite(df["loss"]).all() and "UAR" in df
    cfg = json.load(open(os.path.join(first.run_dir, "config.json")))
    assert cfg["video_freeze"] is False and cfg["device"] == "cpu"
    # the video tower is trainable, as --video_freeze false asks
    video = first.state.model.extractors["video"]
    assert all(p.requires_grad for p in video.parameters())


def test_resume_continues_at_the_next_epoch(run):
    _, first, _, resumed = run
    assert resumed.start_epoch == 2 and resumed.state.step > first.state.step
    df = pd.read_csv(os.path.join(resumed.run_dir, "verb_train_log.csv"))
    assert df["epoch"].tolist() == [0, 1, 2]


def test_best_checkpoint_serves(run):
    _, first, _, _ = run
    cfg = ServeConfig(modalities=",".join(MODALITIES), **SIZES, batch_size=2,
                      device="cpu", port=0,
                      path_to_checkpoint=os.path.join(
                          first.run_dir, "checkpoint_best_phys"))
    srv = build_server(cfg)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)
        clip = {"audio": (rng.standard_normal(4000) * 0.1).round(3).tolist(),
                "text": rng.standard_normal((3, 768)).round(3).tolist(),
                "video": rng.standard_normal((8, 32, 32, 3)).round(3).tolist()}
        host, port = srv.server_address[:2]
        req = urllib.request.Request(
            f"http://{host}:{port}/score", data=json.dumps(clip).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        for head in ("phys", "verb"):
            assert np.isclose(np.sum(got[head][0]), 1.0, atol=1e-3)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=30)


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = [a for a in _args(tmp_path, 1) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_multimodal.main(args)
    assert not (tmp_path / "ds").exists()  # failed before any data work
