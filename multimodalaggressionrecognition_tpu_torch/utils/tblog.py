"""Optional TensorBoard scalar sink for training metrics (the JAX package's
utils/tblog.py).

The per-head CSV logs and PNG curves stay the record (train/loop.py); with
`--tensorboard_dir` the trainer also writes per-epoch scalars
`<head>/<split>/<metric>` through `torch.utils.tensorboard.SummaryWriter`.
The `tensorboard` package is imported only when a writer is made; without
it the writer is a no-op that prints one warning, so training never depends
on it.
"""

import numpy as np


class TBWriter:
    """Per-epoch scalar writer; a no-op when tensorboard is not installed."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            print(f"[tblog] tensorboard not available; TensorBoard scalars "
                  f"to {logdir!r} disabled (CSV/PNG logs unaffected)",
                  flush=True)
            return
        self._writer = SummaryWriter(logdir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def log(self, split: str, epoch: int, results: dict):
        """results: {head: {metric: value}}; scalars only (the per-class
        precision, recall and f1 arrays stay in the CSVs)."""
        if self._writer is None:
            return
        for head, metrics in results.items():
            for name, value in metrics.items():
                if isinstance(value, (int, float, np.floating, np.integer)):
                    self._writer.add_scalar(f"{head}/{split}/{name}",
                                            float(value), global_step=epoch)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
