"""Inference/serving API: a fixed-batch predictor and a micro-batcher.

`Predictor` wraps a multimodal model and its weights into one scorer with a
fixed batch shape: variable-size request batches are padded up to it with
all-zero, `present=0` rows and scored in one forward on the device.
`MicroBatcher` sits in front of it for online serving: concurrent
single-clip requests are coalesced into one forward, bounded by a
max-delay deadline.  Semantics follow the JAX package's serve.py; bf16
compute, int8 quantization, sharded serving and the compile cache are not
ported yet.
"""

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device entry points run on: CUDA unless the caller asks for the
    CPU.  No silent fallback: CUDA requested without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU")
    return device


class ScorerBase:
    """Shared pad-and-score surface: fixed batch shape, requests padded up
    to it, scores sliced back.  Implementations set `batch_size`, `device`
    and `_forward(batch) -> {head: logits tensor}`."""

    batch_size: int
    device: torch.device

    def _pad_batch(self, modalities: Dict[str, np.ndarray], n: int):
        present = torch.zeros((self.batch_size,), dtype=torch.float32)
        present[:n] = 1.0
        present = present.to(self.device)
        out = {}
        for name, data in modalities.items():
            data = np.asarray(data, np.float32)
            padded = np.zeros((self.batch_size,) + data.shape[1:], np.float32)
            padded[:n] = data
            out[name] = {"data": torch.from_numpy(padded).to(self.device),
                         "present": present}
        return out

    def predict(self, modalities: Dict[str, np.ndarray],
                return_probs: bool = True):
        """modalities: {name: (n, ...)} with n <= batch_size.

        Returns {head: (n, classes)} probabilities (or logits), numpy."""
        n = next(iter(modalities.values())).shape[0]
        if n > self.batch_size:
            raise ValueError(f"request batch {n} > compiled {self.batch_size}")
        logits = self._forward(self._pad_batch(modalities, n))
        out = {}
        for head, lg in logits.items():
            lg = lg[:n].float()
            out[head] = (torch.softmax(lg, dim=-1) if return_probs
                         else lg).cpu().numpy()
        return out


class Predictor(ScorerBase):
    """Batched scorer for PhysVerb-style models.

    model: a module following the batch-dict protocol
           ({modality: {'data', 'present'}} -> {head: logits}).
    state_dict: its weights (e.g. io.checkpoint.restore_variables or
           io.from_jax.from_jax_variables); None keeps the model's own.
    batch_size: fixed batch size; requests are padded up to it.
    device: "cuda" (default) or "cpu"; CUDA without a card raises.
    """

    def __init__(self, model: torch.nn.Module, state_dict=None,
                 batch_size: int = 32, device="cuda"):
        self.device = resolve_device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size

    @torch.inference_mode()
    def _forward(self, batch):
        return self.model(batch)

    def warmup(self, example_modalities: Dict[str, np.ndarray]):
        """Run once on zero inputs shaped like a real request: builds the
        kernels and records the head names and the served modality set."""
        out = self._forward(self._pad_batch(example_modalities, 1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.heads = sorted(out)
        self.modalities = sorted(example_modalities)
        return self


class MicroBatcher:
    """Dynamic micro-batching front-end for `Predictor`.

    Concurrent callers `submit()` small request batches (usually one clip)
    and get a Future; a background batcher coalesces whatever is pending —
    up to the predictor's batch size, waiting at most `max_delay_ms` after
    the first request — into ONE padded forward, then splits the scores
    back per caller.

    All requests must carry the predictor's modality set (one presence
    pattern); a mismatched or oversized request fails only its own Future,
    and a request whose modalities disagree on batch size is rejected at
    submit() before it can misalign the merged group.
    """

    def __init__(self, predictor: ScorerBase, max_delay_ms: float = 2.0,
                 return_probs: bool = True):
        self.predictor = predictor
        self.max_delay = max_delay_ms / 1e3
        self.return_probs = return_probs
        # observability counters, written only by the batcher thread:
        # dispatches = forwards, clips = real rows scored —
        # clips/dispatches is the achieved coalescing factor
        self.stats = {"dispatches": 0, "clips": 0, "failed_requests": 0}
        self._queue: queue.Queue = queue.Queue()
        self._holdover = None  # request that didn't fit the last group
        self._closed = False
        # guards the closed-check+enqueue pair: without it a submit racing
        # close() could enqueue after the drain loop exited, leaving its
        # Future unresolved forever
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def submit(self, modalities: Dict[str, np.ndarray]) -> Future:
        """modalities: {name: (n, ...)} with 1 <= n <= batch_size.
        Returns a Future resolving to {head: (n, classes)}."""
        fut: Future = Future()
        sizes = {name: np.asarray(v).shape[0] for name, v in modalities.items()}
        if not sizes:
            raise ValueError("empty request: no modalities")
        n = next(iter(sizes.values()))
        if any(s != n for s in sizes.values()):
            raise ValueError(f"modalities disagree on batch size: {sizes}")
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put((modalities, int(n), fut))
        return fut

    def close(self):
        """Drain pending requests, then stop the batcher thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # ordered after every accepted submit
        self._thread.join()

    # ------------------------------------------------------------- internals
    def _next_group(self):
        """Block for the first request, then gather until the batch is full
        or max_delay has elapsed.  Returns (group, stop)."""
        cap = self.predictor.batch_size
        first = self._holdover or self._queue.get()
        self._holdover = None
        if first is None:
            return [], True
        group, total = [first], first[1]
        stop = False
        deadline = time.monotonic() + self.max_delay
        while total < cap:
            try:
                item = self._queue.get(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                break
            if item is None:
                stop = True
                break
            if total + item[1] > cap:
                self._holdover = item
                break
            group.append(item)
            total += item[1]
        return group, stop

    def _run(self):
        while True:
            group, stop = self._next_group()
            if group:
                self._score(group)
            if stop:
                # drain anything enqueued between the sentinel and close()
                while self._holdover is not None or not self._queue.empty():
                    group, _ = self._next_group()
                    if group:
                        self._score(group)
                return

    def _score(self, group):
        try:
            # validate against the SERVED modality set (recorded by
            # Predictor.warmup) so one malformed request fails only its own
            # Future; anchor on the group head only for un-warmed predictors
            want = set(getattr(self.predictor, "modalities", None)
                       or next(iter(group))[0])
            ok = []
            for modalities, n, fut in group:
                if not fut.set_running_or_notify_cancel():
                    continue  # caller cancelled while queued
                if set(modalities) != want:
                    self.stats["failed_requests"] += 1
                    fut.set_exception(ValueError(
                        f"modalities {sorted(modalities)} != batcher group "
                        f"{sorted(want)} (one presence pattern)"))
                else:
                    ok.append((modalities, n, fut))
            if not ok:
                return
            merged = {name: np.concatenate(
                [np.asarray(m[name], np.float32) for m, _, _ in ok])
                for name in want}
            scores = self.predictor.predict(merged,
                                            return_probs=self.return_probs)
            self.stats["dispatches"] += 1
            self.stats["clips"] += sum(n for _, n, _ in ok)
            offset = 0
            for _, n, fut in ok:
                fut.set_result({h: s[offset:offset + n]
                                for h, s in scores.items()})
                offset += n
        except Exception as e:  # scoring failed: fail every waiter, not the thread
            failed = 0
            for _, _, fut in group:
                if not fut.done():
                    fut.set_exception(e)
                    failed += 1
            self.stats["failed_requests"] += failed
