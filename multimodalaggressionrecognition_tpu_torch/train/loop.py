"""Epoch-loop trainer: CSV logs, best-metric checkpoints, resume,
preemption, early stopping (the JAX package's train/loop.py).

- run dir `<saving_dir>/<DD.MM.YYYY, HH-MM-SS> (<model_name>)`, or a fixed
  one (`run_dir`), held by a flock for the trainer's life
  (utils/runlock.py): a second live trainer on it exits;
- per-head CSV logs `{head}_train_log.csv` / `{head}_test_log.csv` with the
  reference's metric set: loss, accuracy, per-class precision/recall/f1
  (stringified arrays), UAR/UAP/UAF1, plus epoch_seconds and clips_per_sec
  for training; with `tensorboard_dir` also TensorBoard scalars
  (utils/tblog.py);
- `checkpoint_current` after every epoch and `checkpoint_best_{head}` on an
  improvement of `1 - criterion` (or of the loss), judged on the EMA
  shadow when one is tracked (`ema_decay`); `early_stop_patience` epochs in
  a row without any head improving end the fit;
- `on_epoch_start(epoch)`, when given, is called at the top of each epoch,
  before the sampler's `set_epoch` (`train_video_rnn --epoch_dirs` moves
  the train source to that epoch's directory);
- SIGTERM (utils/preemption.py) is polled once per train and eval step and
  at the end of each epoch: mid-epoch the trainer writes
  `checkpoint_preempt` (state, epoch, batches done, the metric
  accumulators, seconds so far and the epoch's random-generator state) and
  returns; during eval it saves the whole trained epoch the same way;
- resume from a checkpoint (`load_checkpoint`) or from the run dir's
  `checkpoint_preempt`, else `checkpoint_current` (`resume_latest`); every
  epoch's shuffling and dropout draws are keyed by the epoch, and a partial
  epoch resumes with its generator's saved state and skips the trained
  batches without building them (`BatchLoader.iter_skipping`), so a
  resumed run logs what the uninterrupted one would;
- with `profile_dir`, epoch min(profile_epoch, epochs - 1) trains under
  `torch.profiler` (utils/profiling.py), and its Chrome trace names the
  phases, each recorded as a span (`profiling.span`): the loader's wait
  (`train.next_batch`), the metrics' accumulation (`train.accumulate`),
  the throttle's wait (`train.throttle`), the pin threads' copies
  (`data.pin`), and each `step` with its forward (`step.forward`,
  `step.cast` in bf16; `forward.<modality>`, `forward.fusion`,
  `forward.heads`), `step.loss`, `step.backward` (`step.zero_grad` inside
  it) and `step.optimizer`.

The epoch runs without host synchronisation: each step's metrics are added
into accumulators on the device, and the host reads them once per epoch
(or per preemption snapshot).  `_InflightThrottle` bounds how far the host
may run ahead of the card.

On a data- or tensor-parallel `mesh` (parallel/mesh.py; one process per
rank) every rank runs this loop in lockstep:
- each loader is wrapped in `ProcessLocalBatches`: every rank builds the
  same global batch and keeps its data index's rows;
- the steps sum the loss denominators and the gradients over the data
  group (train/steps.py, train/state.py); the confusion matrices and the
  sample count are summed once an epoch, not once a step;
- rank 0 alone holds the run lock and writes the logs, plots, console,
  TensorBoard and checkpoints; the run dir is rank 0's; every rank takes
  part in a save (the tp gather, the barrier) and restores every file;
- the preemption flag is the ranks' consensus (utils/preemption.py), so
  every rank stops at the same step.
"""

import os
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.pipeline import ProcessLocalBatches, device_prefetch
from ..models.stochastic import set_generator
from ..ops.metrics import metrics_from_confusion
from ..utils import profiling
from ..utils.preemption import NullGuard, PreemptionGuard
from ..utils.runlock import acquire_run_lock
from .state import TrainState, create_train_state
from .steps import eval_step, train_step


def _fmt_metric(v):
    if isinstance(v, np.ndarray):
        return np.array2string(v, precision=6, separator=" ")
    return v


@torch.no_grad()
def _accumulate(acc, metrics, sample_mask=None):
    """Add one step's metrics into the device accumulators, in place: the
    loss weighted by its valid count, the valid count, the confusion matrix
    and the real (unpadded) sample count."""
    for head, m in metrics.items():
        if head == "total_loss":
            continue
        slot = acc.setdefault(head, {
            "loss": torch.zeros((), device=m["loss"].device),
            "valid": torch.zeros((), device=m["loss"].device),
            "confusion": torch.zeros_like(m["confusion"])})
        slot["loss"] += m["loss"] * m["valid"]
        slot["valid"] += m["valid"]
        slot["confusion"] += m["confusion"]
    if sample_mask is not None:
        if "_samples" not in acc:
            acc["_samples"] = torch.zeros((), device=sample_mask.device)
        acc["_samples"] += sample_mask.sum()
    return acc


def _encode_acc(acc):
    """The accumulators as plain floats and lists, for a partial
    checkpoint's meta (the snapshot's one readback)."""
    return {head: {"loss": float(s["loss"]), "valid": float(s["valid"]),
                   "confusion": s["confusion"].cpu().tolist()}
            for head, s in acc.items() if head != "_samples"}


def _decode_acc(enc, samples, device, keep_sums: bool = True):
    """_encode_acc's output back into device accumulators (f32, exact).
    Without `keep_sums` (a data rank other than 0) the confusion and the
    sample count restart at 0, as the epoch's sum over the data group
    counts the saved ones once; the loss and valid sums are global on
    every rank and are kept."""
    acc = {head: {k: torch.tensor(s[k], dtype=torch.float32, device=device)
                  for k in ("loss", "valid", "confusion")}
           for head, s in enc.items()}
    acc["_samples"] = torch.tensor(float(samples), device=device)
    if not keep_sums:
        for head in enc:
            acc[head]["confusion"].zero_()
        acc["_samples"].zero_()
    return acc


@torch.no_grad()
def _sum_over(acc, group):
    """The accumulators with the per-rank parts (the confusion matrices
    and the sample count) summed over the data group."""
    from ..parallel.mesh import all_reduce_

    out = {head: dict(slot) for head, slot in acc.items()
           if head != "_samples"}
    for slot in out.values():
        slot["confusion"] = all_reduce_(slot["confusion"].clone(), group)
    if "_samples" in acc:
        out["_samples"] = all_reduce_(acc["_samples"].clone(), group)
    return out


class _InflightThrottle:
    """Bound how far the host epoch loop runs ahead of the card.

    Without a per-step readback the loop never blocks, and every enqueued
    but unexecuted step pins its input batch in device memory (a 128-frame
    video batch is ~150 MB).  An event is recorded after each step; past
    `depth` of them the host waits on the newest of the older half, so at
    most ~depth steps are in flight while dispatch still runs ahead."""

    def __init__(self, depth: int, device):
        self.depth = max(int(depth), 2)
        self.cuda = torch.device(device).type == "cuda"
        self._q = deque()

    def push(self):
        if not self.cuda:
            return
        event = torch.cuda.Event()
        event.record()
        self._q.append(event)
        if len(self._q) > self.depth:
            while len(self._q) > self.depth // 2:
                newest = self._q.popleft()
            newest.synchronize()


class Trainer:
    def __init__(self, model, loss_specs, optimizer, train_loader,
                 test_loader, num_classes: int, saving_dir: str,
                 model_name: str, device, checkpoint_criterion: str = "UAR",
                 seed: int = 0, log_console: bool = True,
                 run_dir: Optional[str] = None, inflight_steps: int = 4,
                 on_epoch_start: Optional[Callable[[int], None]] = None,
                 compute_dtype=None, ema_decay: float = 0.0,
                 early_stop_patience: int = 0,
                 profile_dir: Optional[str] = None, profile_epoch: int = 1,
                 tensorboard_dir: Optional[str] = None, mesh=None):
        """`optimizer`: a train.state.OptimizerConfig.  `mesh`: this rank's
        parallel.mesh.Mesh of a data- or tensor-parallel run (its device
        replaces `device`), or None."""
        self.model = model
        self.on_epoch_start = on_epoch_start
        self.loss_specs = loss_specs
        self.optimizer = optimizer
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            train_loader = ProcessLocalBatches(train_loader, mesh.dp_rank,
                                               mesh.dp)
            test_loader = ProcessLocalBatches(test_loader, mesh.dp_rank,
                                              mesh.dp)
        self.is_main_process = mesh is None or mesh.is_main
        if not self.is_main_process:  # the console and TensorBoard are
            log_console, tensorboard_dir = False, None  # rank 0's
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.num_classes = num_classes
        self.model_name = model_name
        self.device = torch.device(device)
        self.checkpoint_criterion = checkpoint_criterion
        self.seed = seed
        self.log_console = log_console
        self.inflight_steps = inflight_steps
        self.compute_dtype = compute_dtype
        self.ema_decay = ema_decay
        self.early_stop_patience = early_stop_patience
        self.profile_dir = profile_dir
        self.profile_epoch = profile_epoch
        self.tensorboard_dir = tensorboard_dir
        # a stand-in guard can be injected (tests, schedulers that signal
        # preemption by other means than SIGTERM)
        self.preemption_guard = None
        self._tb = None
        if run_dir is None:
            stamp = time.strftime("%d.%m.%Y, %H-%M-%S")
            run_dir = os.path.join(saving_dir, f"{stamp} ({model_name})")
        if mesh is not None and mesh.world > 1:
            from ..parallel.mesh import broadcast_object

            run_dir = broadcast_object(run_dir)  # rank 0's time stamp
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        self._release_runlock = self._run_lock()
        self.state: Optional[TrainState] = None
        self.start_epoch = 0
        self.best_errors: Dict[str, float] = {}
        self.logs: Dict[str, list] = {}
        self._guard = NullGuard()
        self._partial = None  # a preempted epoch's snapshot, to resume
        self._snapshot = None  # the last train_epoch's snapshot

    def on_main(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) on rank 0 only (None elsewhere): the run dir
        is shared, so every write to it goes through here."""
        if self.is_main_process:
            return fn(*args, **kwargs)
        return None

    def _run_lock(self):
        """Rank 0 holds the run dir's lock; the others hold nothing."""
        return self.on_main(acquire_run_lock, self.run_dir) or (lambda: None)

    # ------------------------------------------------------------------ state
    def init_state(self):
        if self.state is None:
            self.state = create_train_state(self.model, self.optimizer,
                                            self.device, self.ema_decay,
                                            self.mesh)
        return self.state

    def _global(self, acc):
        """The epoch's accumulators, summed over the data group."""
        if self.mesh is None:
            return acc
        return _sum_over(acc, self.mesh.dp_group)

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The dropout and stochastic-depth stream of `epoch`: keyed by the
        seed and the epoch only, so a resumed run draws what the
        uninterrupted one would."""
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.seed + 1) * 1_000_003 + epoch)

    def batches(self, loader):
        return device_prefetch(iter(loader), self.device)

    def train_step(self, batch):
        return train_step(self.state, batch, self.loss_specs,
                          self.num_classes, self.compute_dtype)

    def eval_step(self, batch):
        return eval_step(self.state, batch, self.loss_specs,
                         self.num_classes, self.compute_dtype)

    # ------------------------------------------------------------------ epochs
    def _epoch_results(self, acc):
        results = {}
        for head, slot in acc.items():
            if head == "_samples":
                continue
            m = metrics_from_confusion(slot["confusion"].cpu().numpy())
            m["loss"] = float(slot["loss"]) / max(float(slot["valid"]), 1.0)
            results[head] = m
        return results

    def _skipping(self, loader, skip: int):
        """The loader's batches after the first `skip`: skipped unbuilt
        where the loader can (BatchLoader.iter_skipping), else drawn and
        dropped on the host."""
        if skip and hasattr(loader, "iter_skipping"):
            return loader.iter_skipping(skip)
        it = iter(loader)
        for _ in range(skip):
            next(it, None)
        return it

    def train_epoch(self, generator):
        """One training epoch; returns {head: metrics}, or None when
        preempted.  Its snapshot (batches done, samples, accumulators,
        seconds, the generator's state) is left in `self._snapshot`: the
        epoch so far when preempted, the whole epoch otherwise.  A pending
        partial epoch (`self._partial`, from load_checkpoint) resumes: the
        trained batches are skipped, the generator and the accumulators
        continue from its state.  Under a caller's running profiler (a
        benchmark's traced window) the epoch is recorded, its device phases
        timed on the card (`profiling.last_recording()`)."""
        if profiling.profiler_running():
            with profiling.recording(self.device):
                return self._train_epoch(generator)
        return self._train_epoch(generator)

    def _train_epoch(self, generator):
        self.init_state()
        partial, self._partial = self._partial, None
        skip, prior_seconds, acc = 0, 0.0, {}
        if partial is not None:
            skip = int(partial["batches_done"])
            prior_seconds = float(partial.get("seconds", 0.0))
            acc = _decode_acc(partial["acc"], partial["samples"], self.device,
                              self.mesh is None or self.mesh.dp_rank == 0)
            if partial.get("generator") is not None:
                generator.set_state(partial["generator"])
        set_generator(self.model, generator)
        inflight = _InflightThrottle(self.inflight_steps, self.device)
        done = skip
        t0 = time.time()

        def snapshot():
            total = self._global(acc)
            samples = float(total["_samples"]) if "_samples" in total else 0.0
            return {"batches_done": done, "samples": samples,
                    "acc": _encode_acc(total),
                    "seconds": prior_seconds + time.time() - t0,
                    "generator": generator.get_state()}

        batches = device_prefetch(self._skipping(self.train_loader, skip),
                                  self.device)
        while True:
            step = self.state.step
            with profiling.span("train.next_batch", step):
                batch = next(batches, None)
            if batch is None:
                break
            metrics = self.train_step(batch)
            with profiling.span("train.accumulate", step):
                _accumulate(acc, metrics, batch["sample_mask"])
            with profiling.span("train.throttle", step):
                inflight.push()
            done += 1
            if self._guard.should_stop():
                self._snapshot = snapshot()
                return None
        self._snapshot = snapshot()  # the epoch's one readback
        results = self._epoch_results(self._global(acc))
        elapsed = max(self._snapshot["seconds"], 1e-9)
        for m in results.values():
            m["epoch_seconds"] = round(elapsed, 2)
            m["clips_per_sec"] = round(self._snapshot["samples"] / elapsed, 2)
        return results

    def eval_epoch(self):
        """The test-set pass; None when preempted (it has no side effects,
        so a resumed run simply runs it again)."""
        self.init_state()
        acc = {}
        inflight = _InflightThrottle(self.inflight_steps, self.device)
        for batch in self.batches(self.test_loader):
            _accumulate(acc, self.eval_step(batch))
            inflight.push()
            if self._guard.should_stop():
                return None
        return self._epoch_results(self._global(acc))

    # ------------------------------------------------------------------ logging
    def _append_log(self, split, epoch, results):
        import pandas as pd

        for head, metrics in results.items():
            row = {"epoch": epoch}
            row.update({k: _fmt_metric(v) for k, v in metrics.items()})
            key = f"{head}_{split}"
            self.logs.setdefault(key, []).append(row)
            self.on_main(pd.DataFrame(self.logs[key]).to_csv,
                         os.path.join(self.run_dir, f"{head}_{split}_log.csv"),
                         index=False)
        if self.tensorboard_dir:
            if self._tb is None:
                from ..utils.tblog import TBWriter

                self._tb = TBWriter(self.tensorboard_dir)
            self._tb.log(split, epoch, results)

    def _print_results(self, epoch, split, results):
        if not self.log_console:
            return
        for head, m in results.items():
            print(f"[epoch {epoch}] {split} {head}: "
                  f"loss={m['loss']:.4f} acc={m['accuracy']:.4f} "
                  f"UAR={m['UAR']:.4f} UAP={m['UAP']:.4f} "
                  f"UAF1={m['UAF1']:.4f}", flush=True)

    # ------------------------------------------------------------------ ckpt
    def _error(self, metrics):
        if self.checkpoint_criterion == "loss":
            return metrics["loss"]
        return 1.0 - metrics[self.checkpoint_criterion]

    def _save(self, name, meta, extra=None):
        from ..io.checkpoint import save_state

        save_state(os.path.join(self.run_dir, name), self.state,
                   {"step": self.state.step, **meta}, extra)

    def save_checkpoint(self, epoch):
        self._save("checkpoint_current",
                   {"epoch": epoch, "best_errors": self.best_errors,
                    "model_name": self.model_name})

    def maybe_save_best(self, epoch, results):
        """Save `checkpoint_best_{head}` for every head that improved;
        returns whether any did (early stopping's counter)."""
        improved = False
        for head, metrics in results.items():
            err = float(self._error(metrics))
            if err < self.best_errors.get(head, float("inf")):
                improved = True
                self.best_errors[head] = err
                self._save(f"checkpoint_best_{head}",
                           {"epoch": epoch, "head": head,
                            "criterion": self.checkpoint_criterion,
                            "error": err})
        return improved

    def save_preempt_checkpoint(self, epoch, snapshot):
        """The partial checkpoint: the state after `batches_done` steps of
        `epoch`, the accumulators and seconds so far, and the generator's
        state: everything an exact mid-epoch resume needs."""
        snapshot = dict(snapshot)
        generator = snapshot.pop("generator")
        self._save("checkpoint_preempt",
                   {"partial": True, "epoch": epoch,
                    "best_errors": self.best_errors,
                    "model_name": self.model_name, **snapshot},
                   {"generator": generator})
        if self.log_console:
            print(f"[preemption] saved partial checkpoint at epoch {epoch}, "
                  f"batch {snapshot['batches_done']}: "
                  f"{os.path.join(self.run_dir, 'checkpoint_preempt')}",
                  flush=True)

    def _clear_preempt_checkpoint(self):
        path = os.path.join(self.run_dir, "checkpoint_preempt")
        if os.path.isfile(path):
            self.on_main(os.remove, path)

    def load_checkpoint(self, path):
        """Restore model, optimizer, EMA and bookkeeping.  Training
        continues at the epoch after the checkpoint's, or inside a partial
        checkpoint's epoch where it stopped."""
        from ..io.checkpoint import restore_state

        self.init_state()
        meta, extra = restore_state(path, self.state)
        self.state.step = int(meta.get("step", 0))
        self.best_errors = dict(meta.get("best_errors", {}))
        if meta.get("partial"):
            self.start_epoch = int(meta["epoch"])
            self._partial = {k: meta[k] for k in ("batches_done", "samples",
                                                  "acc", "seconds")}
            self._partial["generator"] = extra.get("generator")
        else:
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self._partial = None
        self._load_logs()
        return meta

    def _load_logs(self):
        """Keep this run dir's log rows of the epochs before start_epoch, so
        a resumed run appends to its history."""
        import pandas as pd

        self.logs = {}
        for fname in sorted(os.listdir(self.run_dir)):
            if not fname.endswith("_log.csv"):
                continue
            df = pd.read_csv(os.path.join(self.run_dir, fname))
            rows = [r for r in df.to_dict("records")
                    if int(r.get("epoch", -1)) < self.start_epoch]
            if rows:
                self.logs[fname[:-len("_log.csv")]] = rows

    def resume_latest(self):
        """Resume from this run dir's checkpoint_preempt (always written
        after the last epoch's save), else its checkpoint_current, if it has
        one."""
        for name in ("checkpoint_preempt", "checkpoint_current"):
            path = os.path.join(self.run_dir, name)
            if os.path.isfile(path):
                return self.load_checkpoint(path)
        return None

    # ------------------------------------------------------------------ fit
    def fit(self, epochs: int):
        # again, in case an earlier fit() released it
        self._release_runlock = self._run_lock()
        guard = self.preemption_guard or PreemptionGuard()
        try:
            with guard as self._guard:
                self._fit_epochs(epochs)
        finally:
            self._guard = NullGuard()
            if self._tb is not None:
                self._tb.close()
                self._tb = None
            self._release_runlock()
        return self

    def _fit_epochs(self, epochs: int):
        flat_epochs = 0
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if self.on_epoch_start is not None:
                self.on_epoch_start(epoch)
            sampler = getattr(self.train_loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            generator = self.epoch_generator(epoch)
            if self.profile_dir and epoch == min(self.profile_epoch,
                                                 epochs - 1):
                with profiling.trace(self.profile_dir):
                    train_results = self.train_epoch(generator)
            else:
                train_results = self.train_epoch(generator)
            if train_results is None:  # preempted mid-epoch
                self.save_preempt_checkpoint(epoch, self._snapshot)
                break
            test_results = self.eval_epoch()
            if test_results is None:
                # preempted during eval: the epoch is trained; resume runs
                # only its eval and logging
                self.save_preempt_checkpoint(epoch, self._snapshot)
                break
            self._append_log("train", epoch, train_results)
            self._append_log("test", epoch, test_results)
            self._print_results(epoch, "train", train_results)
            self._print_results(epoch, "test", test_results)
            if self.log_console:
                print(f"[epoch {epoch}] {time.time() - t0:.1f}s", flush=True)
            self.save_checkpoint(epoch)
            improved = self.maybe_save_best(epoch, test_results)
            self._clear_preempt_checkpoint()
            flat_epochs = 0 if improved else flat_epochs + 1
            if 0 < self.early_stop_patience <= flat_epochs:
                if self.log_console:
                    print(f"[epoch {epoch}] early stop: no "
                          f"{self.checkpoint_criterion} improvement in "
                          f"{flat_epochs} epochs", flush=True)
                break
            if self._guard.should_stop():  # preempted after the epoch's
                break                      # save: nothing more to keep

    def plot_logs(self):
        """Training-curve PNGs per head, one panel per logged metric with
        train and test overlaid; skipped without matplotlib."""
        self.on_main(self._plot_logs)

    def _plot_logs(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return

        skip = {"epoch", "epoch_seconds", "clips_per_sec"}
        heads = {k.rsplit("_", 1)[0] for k in self.logs}
        for head in heads:
            splits = {s: self.logs.get(f"{head}_{s}", [])
                      for s in ("train", "test")}
            cols = []
            for rows in splits.values():
                for r in rows:
                    for k, v in r.items():
                        if (k not in skip and k not in cols
                                and isinstance(v, (int, float))):
                            cols.append(k)
            if not cols:
                continue
            ncols = min(3, len(cols))
            nrows = -(-len(cols) // ncols)
            fig, axes = plt.subplots(nrows, ncols,
                                     figsize=(5 * ncols, 3.5 * nrows),
                                     squeeze=False)
            for j, col in enumerate(cols):
                ax = axes[j // ncols][j % ncols]
                for split, rows in splits.items():
                    pts = [(r["epoch"], r[col]) for r in rows if col in r]
                    if pts:
                        ax.plot(*zip(*pts), label=split, marker=".")
                ax.set_title(f"{head} {col}")
                ax.set_xlabel("epoch")
                ax.legend()
            for j in range(len(cols), nrows * ncols):
                axes[j // ncols][j % ncols].axis("off")
            fig.tight_layout()
            fig.savefig(os.path.join(self.run_dir, f"{head}_curves.png"))
            plt.close(fig)
