"""Profiling hooks (the JAX package's utils/profiling.py).

- `trace(dir)`: a context manager around `torch.profiler.profile` (host and,
  on a card, CUDA activity) that exports one Chrome trace,
  `<dir>/trace_<pid>_<ns>.json`, viewable in Perfetto or chrome://tracing;
- `StepTimer`: per-section wall-clock means on the host clock.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


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
    with profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(out["path"])


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
