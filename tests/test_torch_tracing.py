"""The port's span recorder (utils/profiling.py) on the CPU: a shared no-op
while off; nesting, step indices and threads while on; the backward split
by tower at the towers' prehooks; a trainer epoch's spans; and the span
names in the `--profile_dir` epoch's Chrome trace."""

import glob
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multimodalaggressionrecognition_tpu_torch.data import pipeline
from multimodalaggressionrecognition_tpu_torch.models.physverb import (
    PhysVerbClassifierConcatFeatures, PhysVerbModel)
from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig)
from multimodalaggressionrecognition_tpu_torch.train.steps import LossSpec
from multimodalaggressionrecognition_tpu_torch.utils import profiling

STEP_CHILDREN = ["step.forward", "step.loss", "step.backward",
                 "step.optimizer"]


def _model():
    """Two towers (audio, video) into PhysVerb concat heads, no fusion."""
    torch.manual_seed(0)
    return PhysVerbModel(
        {"audio": torch.nn.Linear(3, 6), "video": torch.nn.Linear(5, 6)},
        PhysVerbClassifierConcatFeatures(
            2, {"audio": (6, 4), "video": (6, 4)}, dropout=0.0),
        modalities=("audio", "video"))


def _batch(seed=0, rows=4):
    rng = np.random.default_rng(seed)
    ones = np.ones((rows,), np.float32)
    return {"modalities": {
        "audio": {"data": rng.normal(size=(rows, 2, 3)).astype(np.float32),
                  "present": ones},
        "video": {"data": rng.normal(size=(rows, 3, 5)).astype(np.float32),
                  "present": ones}},
        "labels": {h: rng.integers(0, 2, rows).astype(np.int32)
                   for h in ("phys", "verb")},
        "label_mask": {"phys": ones, "verb": ones},
        "sample_mask": ones}


def _tensors(batch):
    return pipeline._tree_map(torch.from_numpy, batch)


def _trainer(tmp_path, batches, **kw):
    return Trainer(_model(), {"phys": LossSpec("ce"), "verb": LossSpec("ce")},
                   OptimizerConfig(learning_rate=1e-2), batches, batches[:1],
                   num_classes=2, saving_dir=str(tmp_path), model_name="trace",
                   device="cpu", run_dir=str(tmp_path / "run"),
                   log_console=False, **kw)


def _names(spans):
    return [s.name for s in spans]


def test_off_is_a_shared_noop_that_keeps_nothing():
    assert profiling._active is None
    before = profiling.last_recording()
    a, b = profiling.span("step", 3, device=True), profiling.span("x")
    assert a is b is profiling._OFF
    with a, b:
        pass
    out = _model()(_tensors(_batch())["modalities"])
    profiling.backward_mark(out["phys"], "backward.phys")
    assert out["phys"].grad_fn is not None
    assert profiling._active is None
    assert profiling.last_recording() is before


def test_nesting_parents_step_indices_and_threads():
    seen = {}
    with profiling.recording("cpu") as rec:
        with profiling.span("outer", 7) as outer:
            with profiling.span("inner") as inner:
                with profiling.span("leaf", 2) as leaf:
                    pass

            def other():
                with profiling.span("thread") as s:
                    seen["span"] = s

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with profiling.span("top") as top:
            pass
    assert _names(rec.spans) == ["outer", "inner", "leaf", "thread", "top"]
    assert outer.parent is None and inner.parent is outer
    assert leaf.parent is inner and top.parent is None
    assert (outer.step, inner.step, leaf.step, top.step) == (7, 7, 2, None)
    other_span = seen["span"]
    assert other_span.parent is None and other_span.step is None
    assert other_span.thread != outer.thread == threading.get_native_id()
    for s in rec.spans:
        assert rec.opened_ns <= s.start_ns <= s.end_ns <= rec.closed_ns
        assert s.order is None
    assert outer.start_ns <= inner.start_ns <= leaf.end_ns <= outer.end_ns
    assert profiling.last_recording() is rec and profiling._active is None


def test_a_nested_recording_joins_the_open_one():
    with profiling.recording("cpu") as rec:
        with profiling.recording("cpu") as inner:
            with profiling.span("a"):
                pass
        assert inner is rec and profiling._active is rec
    assert _names(rec.spans) == ["a"]


def test_pin_threads_record_batch_order(monkeypatch):
    """`data.pin` spans from the pin threads carry their thread and the
    batch's place in the stream."""
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    with profiling.recording("cpu") as rec:
        with ThreadPoolExecutor(max_workers=2) as pool:
            out = list(pipeline._ordered_window(
                pool, ((pipeline._pinned, b, i)
                       for i, b in enumerate(batches)), 3))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    pins = [s for s in rec.spans if s.name == "data.pin"]
    assert sorted(s.order for s in pins) == list(range(5))
    assert all(s.parent is None and s.step is None for s in pins)
    assert threading.get_native_id() not in {s.thread for s in pins}


def test_backward_segments_per_tower_in_engine_order():
    """The video tower ran last, so its backward starts first; the stretch
    before the first prehook is the heads'; hooks go with the recording."""
    model = _model()
    batch = _tensors(_batch())
    with profiling.recording("cpu") as rec:
        with profiling.span("step", 0):
            loss = sum(v.sum() for v in model(batch["modalities"]).values())
            with profiling.span("step.backward"):
                loss.backward()
        kept = model(batch["modalities"])["phys"].sum()  # no backward yet
    assert [m[0] for m in rec.marks] == ["backward.video", "backward.audio"]
    segments = rec.backward_segments()
    assert [s.name for s in segments] == [
        "backward.fusion_heads_loss", "backward.video", "backward.audio"]
    assert all(s.step == 0 and s.host_ms >= 0 and s.device_ms is None
               for s in segments)
    kept.backward()  # after the recording: no prehook fires
    assert len(rec.marks) == 2 and not rec._handles
    names = _names(rec.spans)
    assert names[:4] == ["step", "forward.audio", "forward.video",
                         "forward.heads"]


def test_trainer_epoch_records_each_step_and_its_phases(tmp_path):
    trainer = _trainer(tmp_path, [_batch(i) for i in range(3)])
    with profiling.recording("cpu") as rec:
        results = trainer.train_epoch(trainer.epoch_generator(0))
    assert results is not None
    steps = [s for s in rec.spans if s.name == "step"]
    assert [s.step for s in steps] == [0, 1, 2] and rec.steps == 3
    for s in steps:
        kids = [c for c in rec.spans if c.parent is s]
        assert _names(kids) == STEP_CHILDREN
        assert all(c.step == s.step for c in kids)
        forward = kids[0]
        assert _names(c for c in rec.spans if c.parent is forward) == [
            "forward.audio", "forward.video", "forward.heads"]
    loop = [(s.name, s.step) for s in rec.spans if s.parent is None
            and s.name.startswith("train.")]
    assert loop == [(name, i) for i in range(3) for name in (
        "train.next_batch", "train.accumulate", "train.throttle")] + [
        ("train.next_batch", 3)]
    segments = rec.backward_segments()
    assert [(s.name, s.step) for s in segments] == [
        (n, i) for i in range(3) for n in (
            "backward.fusion_heads_loss", "backward.video", "backward.audio")]
    summary = rec.summary()
    assert summary["steps"] == 3
    assert set(STEP_CHILDREN) <= set(summary["host_ms"])
    assert summary["device_ms"] == {} and summary["between_steps_ms"] is None
    assert summary["allocator"] == {}


def test_trainer_records_an_epoch_under_a_profiler_only(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer(tmp_path, [_batch(i) for i in range(2)])
    before = profiling.last_recording()
    trainer.train_epoch(trainer.epoch_generator(0))
    assert profiling.last_recording() is before
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_epoch(trainer.epoch_generator(1))
    rec = profiling.last_recording()
    assert rec is not before and rec.profiled and rec.steps == 2
    assert [s.step for s in rec.spans if s.name == "step"] == [2, 3]


def test_profile_dir_trace_names_the_spans(tmp_path):
    """The `--profile_dir` epoch's Chrome trace shows every span the epoch
    opened, by name."""
    prof = str(tmp_path / "prof")
    _trainer(tmp_path, [_batch(i) for i in range(2)], profile_dir=prof,
             profile_epoch=0).fit(1)
    rec = profiling.last_recording()
    assert rec.profiled and not rec.timed and rec.steps == 2
    (path,) = glob.glob(os.path.join(prof, "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in ["train.next_batch", "train.accumulate", "train.throttle",
                 "step", "step.zero_grad",
                 "forward.audio", "forward.video", "forward.heads",
                 *STEP_CHILDREN]:
        assert name in names, name
