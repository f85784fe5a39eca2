"""The benchmark's readers of the port's spans and counters
(`portbench/metrics/`, over `utils/profiling.py`'s recording) on
hand-built run records, and `portbench/attribute.py`'s reading of a trace
on synthetic kernels, launch calls, copies and spans."""

import pytest

from multimodalaggressionrecognition_tpu_torch.utils import profiling
from portbench import attribute as A
from portbench.harness import RunRecord, read_metric

NEW = ["loader_wait_ms", "throttle_wait_ms", "forward_host_ms",
       "backward_host_ms", "optimizer_host_ms", "video_tower_device_ms",
       "optimizer_device_ms", "kernels_per_step", "cuda_malloc_per_step"]
SPANS_READ = [n for n in NEW if n != "kernels_per_step"]
HOST = {"train.next_batch": 1.5, "train.throttle": 40.0,
        "step.forward": 90.0, "step.cast": 12.0, "step.loss": 4.0,
        "step.backward": 80.0, "step.optimizer": 6.0}
DEVICE = {"step": 220.0, "forward.video": 60.0, "backward.video": 110.0,
          "forward.audio": 2.0, "backward.audio": 3.0, "step.optimizer": 2.5}


class Recorded:
    """A stand-in for the program's last recording: its means a step."""

    def __init__(self, steps=4, device=DEVICE, allocator=None,
                 opened_ns=0, closed_ns=10**9):
        self.steps, self.opened_ns, self.closed_ns = steps, opened_ns, closed_ns
        self.means = {"steps": steps, "host_ms": dict(HOST),
                      "device_ms": dict(device), "between_steps_ms": 31.0,
                      "allocator": allocator if allocator is not None else {
                          "num_device_alloc": 3, "num_device_free": 1,
                          "num_alloc_retries": 0}}

    def summary(self):
        return self.means


def record(traced=True, steps=4, at=0):
    """A run record of `steps` steps, its kernels from `at` ns on."""
    kernels = [("gemm", at + i * 10, 5) for i in range(4 * 3000)]
    return RunRecord(cell="c", cfg={}, job={}, card="card", steps=steps,
                     kernels=kernels if traced else None)


@pytest.fixture
def recorded(monkeypatch):
    def use(rec):
        monkeypatch.setattr(profiling, "_last", rec)
    use(Recorded())
    return use


@pytest.mark.parametrize("name, value", [
    ("loader_wait_ms", 1.5), ("throttle_wait_ms", 40.0),
    ("forward_host_ms", 90.0), ("backward_host_ms", 80.0),
    ("optimizer_host_ms", 6.0), ("video_tower_device_ms", 170.0),
    ("optimizer_device_ms", 2.5), ("kernels_per_step", 3000.0), ("cuda_malloc_per_step", 1.0)])
def test_each_reader_reads_its_span_or_counter(recorded, name, value):
    assert read_metric(name, record()) == pytest.approx(value)


def test_a_frozen_tower_reads_its_forward_alone(recorded):
    recorded(Recorded(device={k: v for k, v in DEVICE.items()
                              if k != "backward.video"}))
    assert read_metric("video_tower_device_ms", record()) == 60.0


@pytest.mark.parametrize("name", NEW)
def test_untraced_runs_read_nothing(recorded, name):
    assert read_metric(name, record(traced=False)) is None


@pytest.mark.parametrize("name", SPANS_READ)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    """The parent commit's program has no `last_recording`; off a card
    there are no device phases and no allocator counters either."""
    monkeypatch.delattr(profiling, "last_recording")
    assert read_metric(name, record()) is None


@pytest.mark.parametrize("name", ["video_tower_device_ms",
                                  "optimizer_device_ms",
                                  "cuda_malloc_per_step"])
def test_a_cpu_recording_has_no_device_readings(recorded, name):
    recorded(Recorded(device={}, allocator={}))
    assert read_metric(name, record()) is None


@pytest.mark.parametrize("other", [
    {"steps": 3},  # another epoch's step count
    {"opened_ns": 10**6},  # opened after the window's first kernel
    {"closed_ns": -1},  # closed before it
], ids=["steps", "opened_late", "closed_early"])
@pytest.mark.parametrize("name", SPANS_READ)
def test_another_windows_recording_reads_nothing(recorded, name, other):
    """The last recording counts only where it is the traced window's: the
    same steps, open when the window's first kernel started."""
    recorded(Recorded(**other))
    assert read_metric(name, record()) is None


def test_a_real_cpu_recording_reads_its_host_spans(monkeypatch):
    with profiling.recording("cpu") as rec:
        for step in range(2):
            with profiling.span("step", step):
                with profiling.span("step.forward"):
                    pass
    monkeypatch.setattr(profiling, "_last", rec)
    run = record(steps=2, at=rec.opened_ns)
    value = read_metric("forward_host_ms", run)
    assert value == pytest.approx(sum(
        s.host_ms for s in rec.spans if s.name == "step.forward") / 2)
    assert read_metric("loader_wait_ms", run) is None


# ------------------------------------------------------------ the trace
SPANS = [("step", 0, 1000), ("step.backward", 100, 600),
         ("step.optimizer", 600, 900)]


def test_innermost_span():
    assert A.innermost(SPANS, [700, 50, 300, 1500, 100]) == [
        "step.optimizer", "step", "step.backward", None, "step.backward"]


def test_idle_gaps_are_labelled_by_what_the_host_did():
    us = 1000
    kernels = [("gemm_a", 0, 10 * us, 1),
               # gap 10-20 us, launched at 15 us inside step.optimizer
               ("roll_kernel<16>", 20 * us, 10 * us, 2),
               # gap 30-200 us, launched at 25 us, a copy ends at 190 us
               ("layer_norm_fwd", 200 * us, 10 * us, 3),
               # gap 210-400 us, launched at 205 us, no copy near
               ("gemm_b", 400 * us, 10 * us, 4)]
    calls = [("cudaLaunchKernel", 0, 1), ("cudaLaunchKernel", 15 * us, 2),
             ("cudaLaunchKernel", 25 * us, 3),
             ("cudaLaunchKernel", 205 * us, 4),
             ("cudaEventRecord", 206 * us, 5)]
    spans = [("step.optimizer", 12 * us, 16 * us)]
    copies = [(100 * us, 190 * us)]
    gaps = A.label_gaps(kernels, calls, spans, copies)
    assert gaps == {"host: step.optimizer; after GEMM": 10 * us,
                    "wait: batch copy; after K4": 170 * us,
                    "wait: other; after LayerNorm": 190 * us}
    # lags 0, 5, 175, 195 us
    assert A.launch_queue_ms(kernels, calls) == pytest.approx(0.090)


def test_a_late_launch_outside_every_span_is_unlabelled():
    kernels = [("gemm", 0, 10, 1), ("gemm", 50, 10, 2)]
    calls = [("cudaLaunchKernel", 0, 1), ("cudaLaunchKernel", 30, 2)]
    assert A.label_gaps(kernels, calls, [], []) == {
        "host: None; after GEMM": 40}


def test_launch_calls_inside_spans():
    launched = [("gemm", 50), ("roll", 300), ("add", 950), ("add", 1500)]
    assert A.outside_spans(launched, SPANS) == (0.75, {"add": 1})
    assert A.outside_spans([], SPANS) == (1, {})


def test_the_clock_offset_of_a_cpu_range():
    """`time.time_ns` against the profiler's clock on the CPU: a range
    opened right after a reading starts within a millisecond of it."""
    offsets = A.clock_offsets_us(n=50)
    median, least = offsets["cpu_range"]
    assert least <= median and abs(median) < 1000


def test_device_phases_against_the_step():
    summary = Recorded().summary()
    sums = A.phase_sums(summary, 250.0)
    assert sums["phases_ms"] == pytest.approx(177.5)
    assert sums["step_ms"] == 220.0 and sums["step_interval_ms"] == 250.0
    assert sums["phases_and_between_ms"] == pytest.approx(208.5)
