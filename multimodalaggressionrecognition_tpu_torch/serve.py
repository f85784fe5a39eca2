"""Inference/serving API: a fixed-batch predictor and a micro-batcher.

`Predictor` wraps a multimodal model and its weights into one scorer with a
fixed batch shape: variable-size request batches are padded up to it with
all-zero, `present=0` rows and scored in one forward on the device.
`MicroBatcher` sits in front of it for online serving: concurrent
single-clip requests are coalesced into one forward, bounded by a
max-delay deadline.  Semantics follow the JAX package's serve.py:
`compute_dtype` bf16 casts the floating parameters and inputs inside the
forward (f32 probabilities out), and `quantize` keeps the weights resident
as int8 plus per-channel scales, dequantized inside the forward ("int8")
or multiplied as int8 x int8 -> int32 ("w8a8"), utils/quantize.py.  The
forward is one module (`ServingForward`), which io/export.py hands to
`torch.export` whole.  `devices=[...]` serves data-parallel in one
process (the JAX package's `Predictor(sharding=)`): each listed device
holds a replica, the padded batch is split evenly over them, and every
chunk is enqueued before any result is read back.  With
`model_parallelism=tp` it serves dp x tp in one process (JAX's
`Predictor(sharding=, param_placement=place_params)`): the devices form
JAX's grid `(n // tp, tp)`, row major, so devices d tp ... d tp + tp - 1
are data group d; each group holds one model copy whose transformer
blocks are split over its devices (parallel/sharding_rules
`place_params_local`), and the batch is split evenly over the groups.
The compile cache is not ported.
"""

import copy
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


def data_groups(devices, device, model_parallelism: int = 1):
    """JAX's device grid `(n // tp, tp)` over `devices` (default: [device]
    under tp > 1, else none), row major, as a list of data groups of tp
    resolved devices each; tp must divide the device count."""
    tp = int(model_parallelism)
    devices = [resolve_device(d)
               for d in devices or ((device,) if tp > 1 else ())]
    if tp < 1 or len(devices) % tp:
        raise ValueError(f"model_parallelism {tp} does not divide the "
                         f"{len(devices)} available devices")
    return [tuple(devices[i:i + tp]) for i in range(0, len(devices), tp)]


def _check_batch_divides(batch_size: int, devices):
    """The fixed batch must split evenly over the replicas."""
    if batch_size % len(devices):
        raise ValueError(
            f"batch_size {batch_size} must divide across the {len(devices)} "
            f"batch shards of devices {[str(d) for d in devices]}")


class ScorerBase:
    """Shared pad-and-score surface: fixed batch shape, requests padded up
    to it, scores sliced back.  Implementations set `batch_size`, `device`
    and `_forward(batch) -> {head: logits tensor}`; a data-parallel scorer
    also sets `devices` (one replica each) and `_replica_forward(i,
    batch)`."""

    batch_size: int
    device: torch.device
    devices: tuple = ()

    def _pad_batch(self, modalities: Dict[str, np.ndarray], n: int,
                   device=None):
        device = self.device if device is None else device
        present = torch.zeros((self.batch_size,), dtype=torch.float32)
        present[:n] = 1.0
        present = present.to(device)
        out = {}
        for name, data in modalities.items():
            data = np.asarray(data, np.float32)
            padded = np.zeros((self.batch_size,) + data.shape[1:], np.float32)
            padded[:n] = data
            out[name] = {"data": torch.from_numpy(padded).to(device),
                         "present": present}
        return out

    def _logits(self, modalities: Dict[str, np.ndarray], n: int):
        """{head: logits} of the padded batch: one forward, or one chunk per
        replica, every chunk enqueued before any is read back."""
        if len(self.devices) <= 1:
            return self._forward(self._pad_batch(modalities, n))
        host = self._pad_batch(modalities, n, torch.device("cpu"))
        per = self.batch_size // len(self.devices)
        outs = []
        for i, device in enumerate(self.devices):
            chunk = {m: {k: v[i * per:(i + 1) * per].to(device)
                         for k, v in leaf.items()}
                     for m, leaf in host.items()}
            outs.append(self._replica_forward(i, chunk))
        return {h: torch.cat([o[h].float().cpu() for o in outs])
                for h in outs[0]}

    def predict(self, modalities: Dict[str, np.ndarray],
                return_probs: bool = True):
        """modalities: {name: (n, ...)} with n <= batch_size.

        Returns {head: (n, classes)} probabilities (or logits), numpy."""
        n = next(iter(modalities.values())).shape[0]
        if n > self.batch_size:
            raise ValueError(f"request batch {n} > compiled {self.batch_size}")
        logits = self._logits(modalities, n)
        out = {}
        for head, lg in logits.items():
            lg = lg[:n].float()
            out[head] = (torch.softmax(lg, dim=-1) if return_probs
                         else lg).cpu().numpy()
        return out


class ServingForward(torch.nn.Module):
    """The Predictor's whole forward as one module: `model` on the batch in
    `compute_dtype` (train/steps.forward), each weight-only int8 weight
    dequantized once per call, f32 logits out."""

    def __init__(self, model: torch.nn.Module, compute_dtype=None):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, modalities):
        from torch.nn.utils import parametrize

        from .train.steps import forward

        with parametrize.cached():
            out = forward(self.model, modalities, self.compute_dtype)
        return {k: v.float() for k, v in out.items()}


class Predictor(ScorerBase):
    """Batched scorer for PhysVerb-style models.

    model: a module following the batch-dict protocol
           ({modality: {'data', 'present'}} -> {head: logits}).
    state_dict: its weights (e.g. io.checkpoint.restore_variables or
           io.from_jax.from_jax_variables); None keeps the model's own.
    batch_size: fixed batch size; requests are padded up to it.
    device: "cuda" (default) or "cpu"; CUDA without a card raises.
    compute_dtype: None / "float32", or "bfloat16" (utils/precision.py).
    quantize: None, "int8" (weight-only) or "w8a8" (utils/quantize.py);
           the model is quantized in place after its weights load.
    devices: a list of devices (e.g. ["cuda:0", "cuda:1"]) to serve
           data-parallel, one replica each (`device` is then the first);
           the batch size must divide by their number.
    model_parallelism: tp > 1 serves dp x tp over `devices` (default
           [device]): tp must divide their number, and the batch size the
           number of data groups; `devices` then holds each group's first
           device (where its batch rows go) and `groups` the groups.
    """

    def __init__(self, model: torch.nn.Module, state_dict=None,
                 batch_size: int = 32, device="cuda", compute_dtype=None,
                 quantize: str | None = None, devices=None,
                 model_parallelism: int = 1):
        from .parallel.sharding_rules import place_params_local
        from .utils.precision import resolve_dtype

        tp = int(model_parallelism)
        self.groups = data_groups(devices, device, tp)
        self.devices = tuple(group[0] for group in self.groups)
        if self.devices:
            _check_batch_divides(batch_size, self.devices)
            device = self.devices[0]
        self.device = resolve_device(device)
        self.compute_dtype = resolve_dtype(compute_dtype)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        if quantize is not None:
            from .utils.quantize import quantize_model_

            quantize_model_(model, quantize,
                            self.compute_dtype or torch.float32)
        self.model = model.to(self.device).eval()
        copies = [self.model] + [copy.deepcopy(self.model).to(d)
                                 for d in self.devices[1:]]
        if tp > 1:
            for replica, group in zip(copies, self.groups):
                place_params_local(replica, group)
        self.replicas = [ServingForward(m, self.compute_dtype)
                         for m in copies]
        self.serving = self.replicas[0]
        self.batch_size = batch_size

    @torch.inference_mode()
    def _forward(self, batch):
        return self.serving(batch)

    @torch.inference_mode()
    def _replica_forward(self, i, batch):
        return self.replicas[i](batch)

    def warmup(self, example_modalities: Dict[str, np.ndarray]):
        """Run once on zero inputs shaped like a real request: builds the
        kernels and records the head names and the served modality set."""
        out = self._logits(example_modalities, 1)
        for device in {d for group in self.groups for d in group} or {
                self.device}:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
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
