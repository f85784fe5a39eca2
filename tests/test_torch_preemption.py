"""Preemption-safe training in the port: SIGTERM -> mid-epoch checkpoint ->
exact resume (the JAX package's tests/test_preemption.py, mirrored).

A stand-in guard stops the trainer after K polls (one per train step, one
per eval batch, one at each epoch's end); a fresh Trainer resumes from
`checkpoint_preempt` and its CSV logs match an uninterrupted run's at the
JAX test's rtol 2e-5.  The real signal: a trainer subprocess on the CPU gets
SIGTERM mid-epoch, exits 0 with a partial checkpoint, and a rerun finishes
with the uninterrupted run's losses.
"""

import csv
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch import nn

from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
    Dropout)
from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, SingleHeadAdapter)


class _StopAfter:
    """Guard double: request preemption after `n` should_stop polls."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def should_stop(self):
        self.calls += 1
        return self.calls >= self.n


def _batches(n_batches=6, batch=8, feat=16):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n_batches):
        x = rng.standard_normal((batch, feat)).astype(np.float32)
        y = rng.integers(0, 2, size=(batch,)).astype(np.int32)
        out.append({
            "modalities": {"feat": {"data": x,
                                    "present": np.ones(batch, np.float32)}},
            "labels": {"main": y},
            "label_mask": {"main": np.ones(batch, np.float32)},
            "sample_mask": np.ones(batch, np.float32),
        })
    return out


class _Mlp(nn.Module):
    def __init__(self, feat=16):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(feat, 32), nn.Linear(32, 2)
        self.drop = Dropout(0.1)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


def _make_trainer(run_dir, guard=None, loader=None):
    torch.manual_seed(0)  # the same initial weights in every trainer
    batches = _batches()
    trainer = Trainer(
        SingleHeadAdapter(_Mlp(), modality="feat"), {"main": LossSpec("ce")},
        OptimizerConfig(learning_rate=3e-3),
        batches if loader is None else loader, batches, num_classes=2,
        saving_dir=run_dir, model_name="pre", device="cpu", run_dir=run_dir,
        log_console=False, seed=0)
    trainer.preemption_guard = guard
    return trainer


def _losses(run_dir, split):
    with open(os.path.join(run_dir, f"main_{split}_log.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def test_preempt_resume_matches_uninterrupted(tmp_path):
    ref_dir = str(tmp_path / "ref")
    _make_trainer(ref_dir).fit(2)

    pre_dir = str(tmp_path / "pre")
    _make_trainer(pre_dir, guard=_StopAfter(3)).fit(2)
    # preempted mid-epoch 0: a partial checkpoint, no completed-epoch logs
    assert os.path.isfile(os.path.join(pre_dir, "checkpoint_preempt"))
    assert not os.path.exists(os.path.join(pre_dir, "main_train_log.csv"))

    t2 = _make_trainer(pre_dir)
    meta = t2.resume_latest()
    assert meta["partial"] and meta["epoch"] == 0 and meta["batches_done"] == 3
    t2.fit(2)
    for split in ("train", "test"):
        np.testing.assert_allclose(_losses(pre_dir, split),
                                   _losses(ref_dir, split), rtol=2e-5)
    # the finished epoch cleared the partial checkpoint
    assert not os.path.exists(os.path.join(pre_dir, "checkpoint_preempt"))
    assert os.path.isfile(os.path.join(pre_dir, "checkpoint_current"))


def test_preempt_during_eval_saves_full_partial(tmp_path):
    """A signal during the test-set pass: the trained epoch is saved as a
    partial with every batch done, and the resume runs only eval and
    logging; the final logs match the uninterrupted run's."""
    ref_dir = str(tmp_path / "ref")
    _make_trainer(ref_dir).fit(2)

    run_dir = str(tmp_path / "run")
    # polls 1-6 are epoch 0's train steps; poll 7 is eval batch 0
    _make_trainer(run_dir, guard=_StopAfter(7)).fit(2)
    assert os.path.isfile(os.path.join(run_dir, "checkpoint_preempt"))

    t2 = _make_trainer(run_dir)
    meta = t2.resume_latest()
    assert meta["partial"] and meta["batches_done"] == 6
    t2.fit(2)
    for split in ("train", "test"):
        np.testing.assert_allclose(_losses(run_dir, split),
                                   _losses(ref_dir, split), rtol=2e-5)


def test_preempt_between_epochs_stops_cleanly(tmp_path):
    run_dir = str(tmp_path / "run")
    # polls 1-6 train steps, 7-12 eval batches, 13 = the epoch's end: the
    # epoch completes, saves normally, and fit stops
    _make_trainer(run_dir, guard=_StopAfter(13)).fit(3)
    assert not os.path.exists(os.path.join(run_dir, "checkpoint_preempt"))
    assert len(_losses(run_dir, "train")) == 1  # only epoch 0 ran

    t2 = _make_trainer(run_dir)
    t2.resume_latest()
    assert t2.start_epoch == 1 and t2._partial is None


def test_resume_keeps_prior_epoch_log_rows(tmp_path):
    """Preempted in epoch 1 after epoch 0 completed: the resumed process
    appends to the CSV history instead of overwriting it."""
    ref_dir = str(tmp_path / "ref")
    _make_trainer(ref_dir).fit(2)

    run_dir = str(tmp_path / "run")
    # epoch 0 costs 13 polls; polls 14-16 are epoch 1's first train steps
    _make_trainer(run_dir, guard=_StopAfter(16)).fit(2)
    assert len(_losses(run_dir, "train")) == 1  # epoch 0 logged

    t2 = _make_trainer(run_dir)
    meta = t2.resume_latest()
    assert meta["partial"] and meta["epoch"] == 1 and meta["batches_done"] == 3
    t2.fit(2)
    for split in ("train", "test"):
        got = _losses(run_dir, split)
        assert len(got) == 2, f"epoch-0 row lost from {split} log"
        np.testing.assert_allclose(got, _losses(ref_dir, split), rtol=2e-5)


_CHILD = r"""
import sys, time
sys.path.insert(0, "@REPO@")
sys.path.insert(0, "@TESTS@")

from test_torch_preemption import _batches, _make_trainer


class _Slow:
    def __init__(self, batches, delay):
        self.batches, self.delay = batches, delay

    def __iter__(self):
        for i, b in enumerate(self.batches):
            time.sleep(self.delay)
            print(f"batch {i}", flush=True)
            yield b

    def __len__(self):
        return len(self.batches)


t = _make_trainer(sys.argv[1], loader=_Slow(_batches(), float(sys.argv[2])))
print("child ready", flush=True)
t.resume_latest()
t.fit(2)
print("child done", flush=True)
"""


def test_sigterm_checkpoint_and_resume(tmp_path):
    """A trainer process on the CPU (device "cpu") gets SIGTERM in epoch 0:
    it writes checkpoint_preempt and exits 0; a rerun finishes both epochs
    with the uninterrupted run's losses."""
    tests = os.path.dirname(os.path.abspath(__file__))
    child = _CHILD.replace("@REPO@", os.path.dirname(tests)).replace(
        "@TESTS@", tests)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run_dir = str(tmp_path / "run")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", child, run_dir, "0.4"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline, seen = time.time() + 120, False
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if "batch 1" in line:  # the remaining slow batches keep the signal
            seen = True        # inside the train loop
            break
    assert seen, "child never reached batch 1"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out[-2000:]
    assert "[preemption] caught signal" in out, out[-2000:]
    assert os.path.isfile(os.path.join(run_dir, "checkpoint_preempt"))
    assert not os.path.exists(os.path.join(run_dir, "main_train_log.csv"))

    resume = subprocess.run(
        [sys.executable, "-u", "-c", child, run_dir, "0.0"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    assert resume.returncode == 0, resume.stdout[-2000:]
    assert "child done" in resume.stdout
    ref_dir = str(tmp_path / "ref")
    _make_trainer(ref_dir).fit(2)
    np.testing.assert_allclose(_losses(run_dir, "train"),
                               _losses(ref_dir, "train"), rtol=2e-5)


def test_resumed_partial_epoch_reports_whole_epoch_time(tmp_path):
    """epoch_seconds and clips_per_sec of a resumed partial epoch cover the
    whole epoch (the seconds before the preemption ride in the snapshot),
    not the remainder: an eval-preempted partial (no step left) would
    otherwise log a near-infinite throughput."""
    t = _make_trainer(str(tmp_path / "run"))
    results = t.train_epoch(t.epoch_generator(0))
    snap = t._snapshot
    assert results is not None and snap["seconds"] > 0
    t._partial = dict(snap, seconds=100.0)  # pretend it took 100 s
    results2 = t.train_epoch(t.epoch_generator(0))
    snap2 = t._snapshot
    assert snap2["batches_done"] == snap["batches_done"] == 6
    assert snap2["samples"] == snap["samples"]
    assert snap2["seconds"] >= 100.0
    for m in results2.values():
        assert m["epoch_seconds"] >= 100.0
        assert m["clips_per_sec"] <= snap["samples"] / 100.0 + 1e-6


def test_cli_file_route_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """train_text_transformer on flat files (RandomBatchSampler), preempted
    mid-epoch 1 and relaunched with the same --run_name: the resumed
    process replays epoch 1's own shuffle (the sampler's epoch is pinned,
    not counted from the new process's iterations), so both epochs log
    what an uninterrupted run logs."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_text_transformer as tcli)
    from multimodalaggressionrecognition_tpu_torch.train import loop

    rng = np.random.default_rng(5)
    for sub, n in (("train", 16), ("test", 4)):
        os.makedirs(tmp_path / "flat" / sub)
        for i in range(n):
            label = "AGGR" if i % 2 else "NOAGGR"
            np.save(tmp_path / "flat" / sub / f"t{i}_{label}.npy",
                    rng.standard_normal((5, 16)).astype(np.float32))

    def run(name):
        return tcli.main([
            "--files_root", str(tmp_path / "flat"), "--hidden_size", "16",
            "--num_heads", "2", "--num_layers", "1", "--text_tokens", "8",
            "--batch_size", "4", "--epoch_num", "2", "--num_threads", "1",
            "--learning_rate", "3e-3", "--saving_dir", str(tmp_path / "runs"),
            "--run_name", name, "--log_console", "false", "--device", "cpu"])

    ref = run("ref").run_dir
    # epoch 0: 4 train steps, 1 eval batch, the epoch's end = 6 polls;
    # polls 7-8 are epoch 1's first two train steps
    with monkeypatch.context() as m:
        m.setattr(loop, "PreemptionGuard", lambda: _StopAfter(8))
        pre = run("pre").run_dir
    assert os.path.isfile(os.path.join(pre, "checkpoint_preempt"))
    assert len(_losses(pre, "train")) == 1
    run("pre")
    assert not os.path.exists(os.path.join(pre, "checkpoint_preempt"))
    for split in ("train", "test"):
        got = _losses(pre, split)
        assert len(got) == 2
        np.testing.assert_allclose(got, _losses(ref, split), rtol=2e-5)


def test_iter_skipping_passes_over_unbuilt_batches():
    """BatchLoader.iter_skipping yields what __iter__ yields after the
    skipped batches, builds none of them, and never counts an all-EMPTY
    batch (which __iter__ does not yield)."""
    from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
        BatchLoader)

    built = []

    class Source:
        def build_batch(self, idx, pad_to=None):
            built.append(idx[0])
            return None if idx[0] % 3 == 2 else {"i": np.array(idx)}

        def batch_is_empty(self, idx):
            return idx[0] % 3 == 2

    loader = BatchLoader(Source(), [[i] for i in range(9)], num_threads=1)
    everything = [int(b["i"][0]) for b in loader]
    assert everything == [0, 1, 3, 4, 6, 7]
    built.clear()
    rest = [int(b["i"][0]) for b in loader.iter_skipping(3)]
    assert rest == everything[3:]
    assert min(built) == 4  # batches 0-3 were passed over unbuilt
    with pytest.raises(ValueError, match="cannot skip"):
        list(loader.iter_skipping(7))
