"""The port's run operations (the JAX package's tests/test_trainer_internals.py
`test_run_lock_excludes_live_owner_reclaims_dead` and
`test_tensorboard_scalars_written`, mirrored): the flock on a run
directory, the TensorBoard scalar sink, and the profiler's trace of one
training epoch.
"""

import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.state import (
    OptimizerConfig)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, SingleHeadAdapter)
from multimodalaggressionrecognition_tpu_torch.utils.runlock import (
    acquire_run_lock)

_HELPER = textwrap.dedent("""
    import sys
    from multimodalaggressionrecognition_tpu_torch.utils.runlock import (
        acquire_run_lock)
    try:
        acquire_run_lock(sys.argv[1])
    except SystemExit as e:
        print("BLOCKED", e)
        sys.exit(3)
    print("ACQUIRED", flush=True)
    if len(sys.argv) > 2 and sys.argv[2] == "hold":
        sys.stdin.readline()  # hold the flock until the parent says so
""")


def _env():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {**os.environ,
            "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _helper(*args, **kw):
    return subprocess.run([sys.executable, "-c", _HELPER, *args],
                          capture_output=True, text=True, env=_env(), **kw)


def test_run_lock_excludes_live_owner_reclaims_dead(tmp_path):
    """A live owner in another process blocks (SystemExit); a dead owner's
    leftover lock file does not (the kernel dropped its flock at exit); a
    second acquire in one process is the same lock; a release hands the
    lock to the next process."""
    d = str(tmp_path)
    # dead owner: the helper acquires and exits; the FILE stays
    assert _helper(d).returncode == 0
    assert (tmp_path / ".runlock.p0").exists()
    release = acquire_run_lock(d)
    assert acquire_run_lock(d) is release  # re-entrant

    probe = _helper(d)
    assert probe.returncode == 3 and "locked by live trainer" in probe.stdout
    assert f":{os.getpid()}" in probe.stdout  # names the owner's host:pid

    release()
    probe = _helper(d)
    assert probe.returncode == 0, probe.stdout + probe.stderr

    holder = subprocess.Popen([sys.executable, "-c", _HELPER, d, "hold"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True, env=_env())
    assert holder.stdout.readline().strip() == "ACQUIRED"
    with pytest.raises(SystemExit, match="locked by live trainer"):
        acquire_run_lock(d)
    holder.stdin.write("done\n")
    holder.stdin.close()
    holder.wait()
    acquire_run_lock(d)()  # acquire and release cleanly


def _batch():
    return {"modalities": {"x": {"data": np.ones((2, 4), np.float32),
                                 "present": np.ones((2,), np.float32)}},
            "labels": {"main": np.array([0, 1], np.int32)},
            "label_mask": {"main": np.ones((2,), np.float32)},
            "sample_mask": np.ones((2,), np.float32)}


def _trainer(tmp_path, **kw):
    batch = _batch()
    return Trainer(SingleHeadAdapter(torch.nn.Linear(4, 2), "x"),
                   {"main": LossSpec("ce")},
                   OptimizerConfig(learning_rate=1e-2), [batch], [batch],
                   num_classes=2, saving_dir=str(tmp_path), model_name="ops",
                   device="cpu", run_dir=str(tmp_path / "run"),
                   log_console=False, **kw)


def test_trainer_holds_its_run_dir(tmp_path):
    """A trainer locks its run dir for its life: a second process's trainer
    on the same dir exits naming the owner; after the first fit the lock is
    released, and a relaunch takes it."""
    t = _trainer(tmp_path)
    blocked = _helper(str(tmp_path / "run"))
    assert blocked.returncode == 3, blocked.stdout
    t.fit(1)  # fit releases at its end
    assert _helper(str(tmp_path / "run")).returncode == 0


def test_tensorboard_scalars_written(tmp_path):
    """--tensorboard_dir writes per-epoch <head>/<split>/<metric> scalars
    next to the CSV logs (utils/tblog.py)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    tb = str(tmp_path / "tb")
    _trainer(tmp_path, tensorboard_dir=tb).fit(2)
    events = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0
    acc = EventAccumulator(tb)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"main/train/loss", "main/test/loss", "main/test/UAR",
            "main/train/clips_per_sec"} <= tags
    assert [e.step for e in acc.Scalars("main/test/loss")] == [0, 1]
    assert not any("precision" in t for t in tags)  # arrays stay in CSVs


def test_tensorboard_missing_is_one_warning(tmp_path, monkeypatch, capsys):
    """Without the tensorboard package the sink is a no-op that warns once."""
    import builtins

    from multimodalaggressionrecognition_tpu_torch.utils import tblog

    real = builtins.__import__

    def no_tb(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    writer = tblog.TBWriter(str(tmp_path / "tb"))
    writer.log("train", 0, {"main": {"loss": 1.0}})
    writer.close()
    assert not writer.enabled
    assert capsys.readouterr().out.count("tensorboard not available") == 1
    assert not os.path.exists(tmp_path / "tb")


def test_profiler_traces_the_profiled_epoch(tmp_path):
    """--profile_dir: the trainer profiles epoch min(profile_epoch,
    epochs - 1) and writes its Chrome trace there."""
    import json

    prof = str(tmp_path / "prof")
    _trainer(tmp_path, profile_dir=prof, profile_epoch=5).fit(2)
    traces = glob.glob(os.path.join(prof, "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("linear" in str(e.get("name", "")).lower() for e in events)


def test_sweep_stops_at_a_preempted_point(tmp_path, monkeypatch):
    """cli.sweep's checkpoint_preempt branch with the port's own trainer: a
    point whose train entry was preempted leaves its file, gets no
    completion marker, and the sweep does not start the next point."""
    from multimodalaggressionrecognition_tpu_torch.cli import sweep

    class _Stop:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def should_stop(self):
            return True

    def entry_main(args):
        run = os.path.join(str(tmp_path / "runs"),
                           args[args.index("--run_name") + 1])
        t = Trainer(SingleHeadAdapter(torch.nn.Linear(4, 2), "x"),
                    {"main": LossSpec("ce")},
                    OptimizerConfig(learning_rate=1e-2), [_batch()],
                    [_batch()], num_classes=2, saving_dir=str(tmp_path),
                    model_name="s", device="cpu", run_dir=run,
                    log_console=False)
        t.preemption_guard = _Stop()
        launched.append(os.path.basename(run))
        return t.fit(2)

    launched = []
    fake = type(sys)("fake_entry")
    fake.main = entry_main
    monkeypatch.setitem(sys.modules, sweep.__package__
                        + ".train_text_transformer", fake)
    sweep.main(["--entry", "train_text_transformer", "--grid", "seed=1,2",
                "--", "--saving_dir", str(tmp_path / "runs")])
    assert launched == ["seed-1"]
    run = tmp_path / "runs" / "seed-1"
    assert (run / "checkpoint_preempt").is_file()
    assert not (run / sweep._DONE_MARKER).exists()
