"""Profiling hooks (the JAX package's utils/profiling.py).

- `trace(dir)`: a context manager around `torch.profiler.profile` (host and,
  on a card, CUDA activity) that exports one Chrome trace,
  `<dir>/trace_<pid>_<ns>.json`, viewable in Perfetto or chrome://tracing;
  its body is recorded (without CUDA events), so the trace names the spans;
- `span(name)`: one phase of the training path (the trainer's loop, the
  train step, the towers, the optimizer); a shared no-op unless a
  `recording()` is open;
- `recording()`: keeps every span opened while it is, in memory: its name,
  the span around it on the same thread, its step index, its thread and
  its start and end on the host's wall clock (`time.time_ns`, the clock of
  `torch.profiler`'s events).  On a card a timed recording also records a
  CUDA event at each end of a span marked `device`, on the current stream,
  and `backward_mark` splits the backward by tower; the events are
  resolved when the recording is first read, never per step.  The
  allocator's counters, the loss's class-weight table builds and hits
  (`ops/losses.TABLE_COUNTS`) and the self-attention kernels' launches
  (`SELF_ATTENTION_KEYS` of `utils/kernels.launch_counts`) are read when
  it opens and closes.  Under a
  running profiler each span is also a `torch.profiler.record_function`
  range, so the profiler's trace shows the phases by name.

`Trainer.train_epoch` records (timed) every epoch that runs under a
caller's profiler, such as a benchmark's traced window, and
`last_recording()` returns the last recording closed.
"""

import contextlib
import os
import statistics
import threading
import time
from typing import Dict, List, Optional

_active = None  # the open Recording
_last = None  # the last Recording closed
_OFF = contextlib.nullcontext()
ALLOCATOR_COUNTERS = ("num_device_alloc", "num_device_free",
                      "num_alloc_retries")
SELF_ATTENTION_KEYS = ("self_attention.bf16", "self_attention_bwd.bf16")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; its Chrome trace lands in `log_dir` (its path is
    the context's value, filled in on exit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = {"path": os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")}
    with profile(activities=activities) as prof, recording(timed=False):
        yield out
    prof.export_chrome_trace(out["path"])


def profiler_running() -> bool:
    """Whether a `torch.profiler` is collecting in this process."""
    from torch.autograd import profiler

    return bool(getattr(profiler, "_is_profiler_enabled", False))


class Span:
    """One recorded span.  `step`: the trainer's step index it belongs to
    (given, else its parent's); `order`: a pin thread's batch order in its
    stream (`data.pin`), None elsewhere; `device_ms`: a device phase's time
    on the card between its two events, once the recording is read."""

    __slots__ = ("name", "parent", "step", "order", "thread", "start_ns",
                 "end_ns", "events", "device_ms")

    def __init__(self, name, parent, step, thread, start_ns, order=None):
        self.name, self.parent, self.step = name, parent, step
        self.order, self.thread = order, thread
        self.start_ns, self.end_ns = start_ns, None
        self.events, self.device_ms = None, None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Segment:
    """One stretch of a step's backward on the card, from one boundary to
    the next: `backward.fusion_heads_loss` before the first tower's
    prehook, then `backward.<tower>` from each tower's prehook on."""

    __slots__ = ("name", "step", "host_ms", "device_ms")

    def __init__(self, name, step, host_ms, device_ms):
        self.name, self.step = name, step
        self.host_ms, self.device_ms = host_ms, device_ms


class Recording:
    """The spans, backward marks, allocator counters, loss-table counts
    and self-attention launches of one window, opened at `opened_ns` and closed at `closed_ns`
    (`time.time_ns`).  `timed`: device phases record CUDA events (on a card
    only)."""

    def __init__(self, device=None, timed=True):
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.timed = timed and self.cuda
        self.profiled = profiler_running()
        self.spans: List[Span] = []
        self.marks = []  # (name, step, ns, event) as each prehook fired
        self.allocator: Dict[str, int] = {}
        self.loss_tables: Dict[str, int] = {}
        self.self_attention: Dict[str, int] = {}
        self._local = threading.local()
        self._handles = []
        self._segments = None
        self._counters = self._allocator_counters()
        self._tables = _loss_table_counts()
        self._launches = _self_attention_counts()
        self.opened_ns, self.closed_ns = time.time_ns(), None

    def _allocator_counters(self):
        if not self.cuda:
            return {}
        import torch

        stats = torch.cuda.memory_stats(self.device)
        return {k: stats[k] for k in ALLOCATOR_COUNTERS if k in stats}

    def _event(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def stack(self) -> list:
        """The open spans of the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def mark_backward(self, tensor, name: str):
        """A prehook on `tensor.grad_fn`: it records when the engine starts
        the backward of what produced `tensor` (a tower's output)."""
        stack = self.stack()
        step = stack[-1].step if stack else None

        def prehook(grad_outputs):
            self.marks.append((name, step, time.time_ns(),
                               self._event() if self.timed else None))

        self._handles.append(tensor.grad_fn.register_prehook(prehook))

    def close(self):
        self.closed_ns = time.time_ns()
        for handle in self._handles:
            handle.remove()
        self._handles = []
        after = self._allocator_counters()
        self.allocator = {k: after[k] - v for k, v in self._counters.items()}
        after = _loss_table_counts()
        self.loss_tables = {k: after[k] - v for k, v in self._tables.items()}
        after = _self_attention_counts()
        self.self_attention = {k: after[k] - v
                               for k, v in self._launches.items()}

    # ------------------------------------------------------------ reading
    def _resolve(self):
        """Each device phase's and backward segment's card time (once)."""
        if self._segments is not None:
            return
        import torch

        if self.timed:
            torch.cuda.synchronize(self.device)
            for s in self.spans:
                if s.events is not None and s.end_ns is not None:
                    s.device_ms = s.events[0].elapsed_time(s.events[1])
        segments = []
        for b in self.spans:
            if b.name != "step.backward" or b.end_ns is None:
                continue
            edges = [("backward.fusion_heads_loss", b.start_ns,
                      b.events and b.events[0])]
            edges += [(n, ns, ev) for n, step, ns, ev in self.marks
                      if step == b.step]
            edges.append((None, b.end_ns, b.events and b.events[1]))
            for (name, ns, ev), (_, ns2, ev2) in zip(edges, edges[1:]):
                segments.append(Segment(
                    name, b.step, (ns2 - ns) / 1e6,
                    ev.elapsed_time(ev2) if ev is not None else None))
        self._segments = segments

    def backward_segments(self) -> List[Segment]:
        """Each step's backward split at the towers' prehooks, in the
        engine's order."""
        self._resolve()
        return self._segments

    @property
    def steps(self) -> int:
        """The train steps recorded."""
        return sum(1 for s in self.spans if s.name == "step")

    def host_ms(self) -> Dict[str, float]:
        """Each span's host ms, summed over the window, a step."""
        out = {}
        for s in self.spans:
            if s.end_ns is not None:
                out[s.name] = out.get(s.name, 0.0) + s.host_ms
        return {k: v / max(self.steps, 1) for k, v in out.items()}

    def device_ms(self) -> Dict[str, float]:
        """Each device phase's and backward segment's card ms, summed over
        the window, a step; empty off a card."""
        self._resolve()
        out = {}
        for s in list(self.spans) + self._segments:
            if s.device_ms is not None:
                out[s.name] = out.get(s.name, 0.0) + s.device_ms
        return {k: v / max(self.steps, 1) for k, v in out.items()}

    def between_steps_ms(self) -> List[float]:
        """Card ms from each step's end event to the next step's start
        event: the epoch's accumulation, and any wait of the compute
        stream on a batch's copy."""
        self._resolve()
        steps = [s for s in self.spans if s.name == "step" and s.events
                 and s.end_ns is not None]
        return [a.events[1].elapsed_time(b.events[0])
                for a, b in zip(steps, steps[1:])]

    def summary(self) -> dict:
        """Means a step: host ms by span, card ms by device phase, the card
        ms between steps; the window's allocator and loss-table counts and
        self-attention launches."""
        between = self.between_steps_ms()
        return {"steps": self.steps, "host_ms": self.host_ms(),
                "device_ms": self.device_ms(),
                "between_steps_ms": statistics.fmean(between)
                if between else None,
                "allocator": self.allocator, "loss_tables": self.loss_tables,
                "self_attention": self.self_attention}


def _loss_table_counts() -> Dict[str, int]:
    from ..ops.losses import TABLE_COUNTS

    return dict(TABLE_COUNTS)


def _self_attention_counts() -> Dict[str, int]:
    from .kernels import launch_counts

    return {k: launch_counts[k] for k in SELF_ATTENTION_KEYS}


class _Open:
    """An open span of `rec`."""

    __slots__ = ("rec", "span", "device", "range")

    def __init__(self, rec, name, step, device, order):
        stack = rec.stack()
        parent = stack[-1] if stack else None
        if step is None and parent is not None:
            step = parent.step
        self.rec, self.device = rec, device and rec.timed
        self.span = Span(name, parent, step, threading.get_native_id(), 0,
                         order)
        self.range = None

    def __enter__(self):
        rec, span = self.rec, self.span
        rec.stack().append(span)
        rec.spans.append(span)
        if rec.profiled:
            from torch.profiler import record_function

            self.range = record_function(span.name)
            self.range.__enter__()
        span.start_ns = time.time_ns()
        if self.device:
            span.events = (rec._event(), None)
        return span

    def __exit__(self, *exc):
        rec, span = self.rec, self.span
        end = time.time_ns()
        if self.device:
            span.events = (span.events[0], rec._event())
        span.end_ns = end
        if self.range is not None:
            self.range.__exit__(*exc)
        rec.stack().pop()
        return False


def span(name: str, step: Optional[int] = None, device: bool = False,
         order: Optional[int] = None):
    """A context manager around one phase, kept while a recording is open
    (a shared no-op otherwise).  `step`: the trainer's step index, else
    the enclosing span's; `device`: also time the phase on the card;
    `order`: a batch's place in its stream, for spans outside a step."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name, step, device, order)


def backward_mark(tensor, name: str):
    """While a recording is open, split the backward where the engine
    starts the backward of `tensor`'s producer (`name`): one hook on
    `tensor.grad_fn`, removed when the recording closes; nothing
    otherwise."""
    rec = _active
    if rec is not None and tensor.grad_fn is not None:
        rec.mark_backward(tensor, name)


@contextlib.contextmanager
def recording(device=None, timed=True):
    """Record the spans opened in the body; the value is the Recording
    (`summary()` for its means).  Inside an open recording the body joins
    it.  `timed`: time the device phases with CUDA events."""
    global _active, _last
    if _active is not None:
        yield _active
        return
    rec = Recording(device, timed)
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec.close()
        _last = rec


def last_recording() -> Optional[Recording]:
    """The last recording closed in this process, or None."""
    return _last
