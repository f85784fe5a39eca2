"""Host -> device input pipeline (the JAX package's data/pipeline.py, without
JAX).

`BatchLoader` builds fixed-shape numpy batches on host threads, in order.
`device_prefetch` uploads them ahead of use: on a CUDA device each batch is
copied into pinned host memory on worker threads, then sent with
non-blocking copies on a side stream; the compute stream waits on an event
recorded after the copies, so a step never reads a batch before it has
arrived, and the copies of the next batches overlap the current step.
"""

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


def _ordered_window(pool, jobs: Iterable, window: int) -> Iterator:
    """Submit `jobs` ((fn, *args) tuples) to `pool` with at most `window`
    in flight, yielding results in submission order."""
    pending = deque()
    it = iter(jobs)
    exhausted = False
    while True:
        while not exhausted and len(pending) < window:
            try:
                job = next(it)
            except StopIteration:
                exhausted = True
                break
            pending.append(pool.submit(*job))
        if not pending:
            return
        yield pending.popleft().result()


def _tree_map(fn, tree):
    """Apply fn to every leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _pinned(batch):
    return _tree_map(lambda a: torch.from_numpy(np.asarray(a)).pin_memory(),
                     batch)


def device_prefetch(batch_iter: Iterable, device, prefetch: int = 2,
                    pin_threads: int = 2) -> Iterator:
    """Iterate `batch_iter` (nested dicts of numpy arrays) as tensors on
    `device`, up to `prefetch` batches ahead."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iter:
            yield _tree_map(
                lambda a: torch.from_numpy(np.asarray(a)).to(device), batch)
        return
    copy_stream = torch.cuda.Stream(device)
    in_flight = deque()

    def ready(batch, event):
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in _leaves(batch):  # allocated on the copy stream, used here
            t.record_stream(compute)
        return batch

    with ThreadPoolExecutor(max_workers=max(pin_threads, 1)) as pool:
        for host in _ordered_window(pool, ((_pinned, b) for b in batch_iter),
                                    prefetch + 1):
            with torch.cuda.stream(copy_stream):
                batch = _tree_map(lambda t: t.to(device, non_blocking=True),
                                  host)
                event = torch.cuda.Event()
                event.record(copy_stream)
            in_flight.append((batch, event))
            if len(in_flight) > prefetch:
                yield ready(*in_flight.popleft())
        while in_flight:
            yield ready(*in_flight.popleft())


class BatchLoader:
    """Sampler + source -> iterator of fixed-shape numpy batches, built on
    `num_threads` host threads and yielded in the sampler's order.  An
    all-EMPTY batch (build_batch -> None) is skipped."""

    def __init__(self, source, sampler, pad_to: Optional[int] = None,
                 num_threads: int = 4):
        self.source = source
        self.sampler = sampler
        self.pad_to = pad_to
        self.num_threads = num_threads

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        batches = list(self.sampler)
        if self.num_threads <= 1:
            built = (self.source.build_batch(idx, pad_to=self.pad_to)
                     for idx in batches)
            yield from (b for b in built if b is not None)
            return
        with ThreadPoolExecutor(self.num_threads) as pool:
            jobs = ((self.source.build_batch, idx, self.pad_to)
                    for idx in batches)
            for b in _ordered_window(pool, jobs, 2 * self.num_threads):
                if b is not None:
                    yield b
