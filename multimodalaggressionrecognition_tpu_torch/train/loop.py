"""Epoch-loop trainer: CSV logs, best-metric checkpoints, resume (the JAX
package's train/loop.py).

- run dir `<saving_dir>/<DD.MM.YYYY, HH-MM-SS> (<model_name>)`, or a fixed
  one (`run_dir`);
- per-head CSV logs `{head}_train_log.csv` / `{head}_test_log.csv` with the
  reference's metric set: loss, accuracy, per-class precision/recall/f1
  (stringified arrays), UAR/UAP/UAF1, plus epoch_seconds and clips_per_sec
  for training;
- `checkpoint_current` after every epoch and `checkpoint_best_{head}` on an
  improvement of `1 - criterion` (or of the loss);
- `on_epoch_start(epoch)`, when given, is called at the top of each epoch,
  before the sampler's `set_epoch` (`train_video_rnn --epoch_dirs` moves
  the train source to that epoch's directory);
- resume from a checkpoint (`load_checkpoint`) or from the run dir's
  `checkpoint_current` (`resume_latest`); every epoch's shuffling and
  dropout draws are keyed by the epoch, so a resumed run continues as the
  uninterrupted one would.

The epoch runs without host synchronisation: each step's metrics are added
into accumulators on the device, and the host reads them once per epoch.
`_InflightThrottle` bounds how far the host may run ahead of the card.

Not ported: preemption and its partial checkpoint, the run lock, EMA,
TensorBoard, the profiler, early stopping and multi-process training.
"""

import os
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.pipeline import device_prefetch
from ..models.stochastic import set_generator
from ..ops.metrics import metrics_from_confusion
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
    def __init__(self, model, loss_specs, learning_rate: float, train_loader,
                 test_loader, num_classes: int, saving_dir: str,
                 model_name: str, device, checkpoint_criterion: str = "UAR",
                 seed: int = 0, log_console: bool = True,
                 run_dir: Optional[str] = None, inflight_steps: int = 4,
                 on_epoch_start: Optional[Callable[[int], None]] = None):
        self.model = model
        self.on_epoch_start = on_epoch_start
        self.loss_specs = loss_specs
        self.learning_rate = learning_rate
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.num_classes = num_classes
        self.model_name = model_name
        self.device = torch.device(device)
        self.checkpoint_criterion = checkpoint_criterion
        self.seed = seed
        self.log_console = log_console
        self.inflight_steps = inflight_steps
        if run_dir is None:
            stamp = time.strftime("%d.%m.%Y, %H-%M-%S")
            run_dir = os.path.join(saving_dir, f"{stamp} ({model_name})")
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        self.state: Optional[TrainState] = None
        self.start_epoch = 0
        self.best_errors: Dict[str, float] = {}
        self.logs: Dict[str, list] = {}

    # ------------------------------------------------------------------ state
    def init_state(self):
        if self.state is None:
            self.state = create_train_state(self.model, self.learning_rate,
                                            self.device)
        return self.state

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
                          self.num_classes)

    def eval_step(self, batch):
        return eval_step(self.state, batch, self.loss_specs,
                         self.num_classes)

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

    def train_epoch(self, generator):
        """One training epoch; returns {head: metrics}."""
        self.init_state()
        set_generator(self.model, generator)
        acc = {}
        inflight = _InflightThrottle(self.inflight_steps, self.device)
        t0 = time.time()
        for batch in self.batches(self.train_loader):
            _accumulate(acc, self.train_step(batch), batch["sample_mask"])
            inflight.push()
        results = self._epoch_results(acc)  # the epoch's one readback
        elapsed = max(time.time() - t0, 1e-9)
        samples = float(acc["_samples"]) if "_samples" in acc else 0.0
        for m in results.values():
            m["epoch_seconds"] = round(elapsed, 2)
            m["clips_per_sec"] = round(samples / elapsed, 2)
        return results

    def eval_epoch(self):
        self.init_state()
        acc = {}
        inflight = _InflightThrottle(self.inflight_steps, self.device)
        for batch in self.batches(self.test_loader):
            _accumulate(acc, self.eval_step(batch))
            inflight.push()
        return self._epoch_results(acc)

    # ------------------------------------------------------------------ logging
    def _append_log(self, split, epoch, results):
        import pandas as pd

        for head, metrics in results.items():
            row = {"epoch": epoch}
            row.update({k: _fmt_metric(v) for k, v in metrics.items()})
            key = f"{head}_{split}"
            self.logs.setdefault(key, []).append(row)
            pd.DataFrame(self.logs[key]).to_csv(
                os.path.join(self.run_dir, f"{head}_{split}_log.csv"),
                index=False)

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

    def _save(self, name, meta):
        from ..io.checkpoint import save_state

        save_state(os.path.join(self.run_dir, name), self.state.model,
                   self.state.optimizer, meta)

    def save_checkpoint(self, epoch):
        self._save("checkpoint_current",
                   {"epoch": epoch, "step": self.state.step,
                    "best_errors": self.best_errors,
                    "model_name": self.model_name})

    def maybe_save_best(self, epoch, results):
        """Save `checkpoint_best_{head}` for every head that improved."""
        for head, metrics in results.items():
            err = float(self._error(metrics))
            if err < self.best_errors.get(head, float("inf")):
                self.best_errors[head] = err
                self._save(f"checkpoint_best_{head}",
                           {"epoch": epoch, "step": self.state.step,
                            "head": head,
                            "criterion": self.checkpoint_criterion,
                            "error": err})

    def load_checkpoint(self, path):
        """Restore model, optimizer and bookkeeping; training continues at
        the epoch after the checkpoint's."""
        from ..io.checkpoint import restore_state

        self.init_state()
        meta = restore_state(path, self.state.model, self.state.optimizer)
        self.state.step = int(meta.get("step", 0))
        self.best_errors = dict(meta.get("best_errors", {}))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
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
        """Resume from this run dir's checkpoint_current, if it has one."""
        path = os.path.join(self.run_dir, "checkpoint_current")
        return self.load_checkpoint(path) if os.path.isfile(path) else None

    # ------------------------------------------------------------------ fit
    def fit(self, epochs: int):
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if self.on_epoch_start is not None:
                self.on_epoch_start(epoch)
            sampler = getattr(self.train_loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            train_results = self.train_epoch(self.epoch_generator(epoch))
            test_results = self.eval_epoch()
            self._append_log("train", epoch, train_results)
            self._append_log("test", epoch, test_results)
            self._print_results(epoch, "train", train_results)
            self._print_results(epoch, "test", test_results)
            if self.log_console:
                print(f"[epoch {epoch}] {time.time() - t0:.1f}s", flush=True)
            self.save_checkpoint(epoch)
            self.maybe_save_best(epoch, test_results)
        return self

    def plot_logs(self):
        """Training-curve PNGs per head, one panel per logged metric with
        train and test overlaid; skipped without matplotlib."""
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
