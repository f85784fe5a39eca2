"""Preemption handling (the JAX package's utils/preemption.py): catch
SIGTERM, checkpoint mid-epoch, exit cleanly.

A `PreemptionGuard` turns the signal into a flag that the trainer polls
once per step (train/loop.py).  On the flag the trainer writes a partial
checkpoint (`checkpoint_preempt`: the state, the epoch, the batches done,
the metric accumulators and the seconds so far) and returns, so the process
exits 0; a relaunch resumes from it and replays the rest of the epoch with
the same batch order and random draws (tests/test_torch_preemption.py).
One process only: the multi-process consensus of the JAX guard belongs to
the multi-GPU work.
"""

import signal
import threading


class PreemptionGuard:
    """Cooperative stop flag set by SIGTERM (and any extra `signals`).

    Use as a context manager around the training loop; `should_stop()` is
    polled at step boundaries.  Entered off the main thread (where
    `signal.signal` is not allowed) it installs no handler and is a flag set
    by `request()` only."""

    def __init__(self, signals=(signal.SIGTERM,), verbose: bool = True):
        self.signals = tuple(signals)
        self.verbose = verbose
        self._flag = threading.Event()
        self._previous = {}

    def __enter__(self):
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread: request() only
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False

    def _handler(self, signum, frame):
        if self.verbose and not self._flag.is_set():
            print(f"[preemption] caught signal {signum}; will checkpoint at "
                  "the next step boundary", flush=True)
        self._flag.set()

    def request(self):
        """Programmatic preemption (tests, external schedulers)."""
        self._flag.set()

    def should_stop(self) -> bool:
        return self._flag.is_set()


class NullGuard:
    """Stand-in when preemption handling is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def should_stop(self):
        return False
