"""Host <-> device pipeline (the JAX package's data/pipeline.py, without
JAX).

`BatchLoader` builds fixed-shape numpy batches on host threads, in order;
`ProcessLocalBatches` keeps one rank's rows of each for data parallelism.
`device_prefetch` uploads them ahead of use: on a CUDA device each batch is
copied into pinned host memory on worker threads, then sent with
non-blocking copies on a side stream; the compute stream waits on an event
recorded after the copies, so a step never reads a batch before it has
arrived, and the copies of the next batches overlap the current step.
`readback` starts the way back: copies of a batch's results into pinned
host memory, queued behind the work that produces them, with an event to
wait on (the feature-dumping entries read batch N-1 back while the card
computes batch N).
"""

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import span


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


def _pinned(batch, order=None):
    """`batch` copied into pinned host memory (`data.pin`, its span keeps
    `order`: the batch's place in the stream)."""
    with span("data.pin", order=order):
        return _tree_map(
            lambda a: torch.from_numpy(np.asarray(a)).pin_memory(), batch)


def readback(tree, device):
    """Start copying `tree` (nested dicts of tensors on `device`) to the host
    behind the work queued so far: (host tree, event).  On a CUDA device the
    host tensors are pinned and hold the values once `event.synchronize()`
    returns; on the CPU the tree itself comes back, and the event is
    None."""
    if torch.device(device).type != "cuda":
        return tree, None
    host = _tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True),
        tree)
    event = torch.cuda.Event()
    event.record()
    return host, event


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
        for host in _ordered_window(
                pool, ((_pinned, b, i) for i, b in enumerate(batch_iter)),
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


class ProcessLocalBatches:
    """This rank's slice of a global batch stream, for data-parallel
    training (the JAX package's data/pipeline.py:71-104).

    Every rank iterates the SAME seeded global batch sequence and keeps the
    contiguous rows `[process_id * B / n, (process_id + 1) * B / n)` of each
    batch's leading axis, so a step over the data group consumes one global
    batch laid out as in the one-process run, and the sampler's
    label-homogeneous batches and epoch order hold globally.  Each rank
    builds the whole batch and slices it (a host cost that grows with the
    world, as in JAX).  `sampler` and `iter_skipping` pass through to the
    wrapped loader (the trainer's epoch seeding and partial-epoch resume).
    """

    def __init__(self, batches, process_id: int = 0, num_processes: int = 1):
        self.batches = batches
        self.process_id = process_id
        self.num_processes = num_processes

    def __len__(self):
        return len(self.batches)

    @property
    def sampler(self):
        return getattr(self.batches, "sampler", None)

    def _local(self, batch):
        from ..parallel.mesh import RowShard

        return _tree_map(RowShard(self.process_id,
                                  self.num_processes).rows, batch)

    def __iter__(self):
        return (self._local(b) for b in self.batches)

    def iter_skipping(self, skip: int):
        inner = (self.batches.iter_skipping(skip)
                 if hasattr(self.batches, "iter_skipping")
                 else itertools.islice(self.batches, skip, None))
        return (self._local(b) for b in inner)


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

    def iter_skipping(self, skip: int):
        """Iterate like __iter__, but pass over the first `skip` yielded
        batches without building them (a resumed partial epoch only needs
        the stream's position).  An all-EMPTY batch is never yielded, so it
        must not count toward `skip`: `source.batch_is_empty(indices)` says
        so from the table alone where the source has it; a source without
        it (which never returns None) counts every sampler batch."""
        batches = iter(list(self.sampler))
        is_empty = getattr(self.source, "batch_is_empty", None)
        skipped = 0
        while skipped < skip:
            idx = next(batches, None)
            if idx is None:
                raise ValueError(
                    f"cannot skip {skip} batches: the loader yields only "
                    f"{skipped}; the resume state does not match this "
                    "dataset")
            if is_empty is None or not is_empty(idx):
                skipped += 1
        return self._iter_indices(list(batches))

    def __iter__(self):
        return self._iter_indices(list(self.sampler))

    def _iter_indices(self, batches):
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
