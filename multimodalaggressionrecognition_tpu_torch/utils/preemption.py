"""Preemption handling (the JAX package's utils/preemption.py): catch
SIGTERM, checkpoint mid-epoch, exit cleanly.

A `PreemptionGuard` turns the signal into a flag that the trainer polls
once per step (train/loop.py).  On the flag the trainer writes a partial
checkpoint (`checkpoint_preempt`: the state, the epoch, the batches done,
the metric accumulators and the seconds so far) and returns, so the process
exits 0; a relaunch resumes from it and replays the rest of the epoch with
the same batch order and random draws (tests/test_torch_preemption.py).

In a multi-rank run the signal may reach one rank only, yet every rank
must stop at the same step (the checkpoint save is a collective), so the
local flag is promoted to a consensus: every `consensus_interval` polls
(the same polls on every rank, which step in lockstep) the ranks
all-reduce their flags with MAX; between those polls `should_stop`
returns the last consensus, never the local flag.  At most
consensus_interval - 1 extra steps run after the signal.
"""

import signal
import threading


class PreemptionGuard:
    """Cooperative stop flag set by SIGTERM (and any extra `signals`).

    Use as a context manager around the training loop; `should_stop()` is
    polled at step boundaries.  Entered off the main thread (where
    `signal.signal` is not allowed) it installs no handler and is a flag set
    by `request()` only."""

    def __init__(self, signals=(signal.SIGTERM,), verbose: bool = True,
                 consensus_interval: int = 8):
        self.signals = tuple(signals)
        self.verbose = verbose
        self.consensus_interval = max(int(consensus_interval), 1)
        self._flag = threading.Event()
        self._previous = {}
        self._polls = 0
        self._consensus = False

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
        """The local flag, or in a multi-rank run the ranks' consensus."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self._flag.is_set()
        if self._consensus:
            return True
        self._polls += 1
        if self._polls % self.consensus_interval:
            return False
        import torch

        from ..parallel.mesh import collective_device

        flag = torch.tensor([float(self._flag.is_set())],
                            device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._consensus = bool(flag.item() > 0)
        return self._consensus


class NullGuard:
    """Stand-in when preemption handling is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def should_stop(self):
        return False
