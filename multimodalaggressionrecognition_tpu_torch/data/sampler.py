"""Aggression-type homogeneous batch sampler (a copy of the JAX package's
data/sampler.py, which the port does not import).

Equivalent of the reference's `AggrBatchSampler` (reference
datasets.py:622-655): indices are grouped per `aggr_type`, chunked into
batches, and the batch order shuffled — every batch therefore shares one
modality-presence pattern.

Deterministic under a seed (the reference reseeded from the OS each epoch;
here epoch e uses seed+e so runs are reproducible and resumable).  The
Trainer pins `set_epoch(epoch)` before each epoch so a resumed run shuffles
exactly like the uninterrupted one; standalone iteration still auto-advances.
"""

from typing import Sequence

import numpy as np


class AggrBatchSampler:
    def __init__(self, aggr_types: Sequence[str], batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.aggr_types = np.asarray(aggr_types)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch (torch DistributedSampler convention) —
        resume at epoch k reproduces uninterrupted epoch-k batch order."""
        self.epoch = int(epoch)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for aggr in np.unique(self.aggr_types):
            idx = np.nonzero(self.aggr_types == aggr)[0]
            if self.shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx), self.batch_size):
                batches.append(idx[i:i + self.batch_size].tolist())
        if self.shuffle:
            rng.shuffle(batches)
        yield from batches
        self.epoch += 1

    def __len__(self):
        n = 0
        for aggr in np.unique(self.aggr_types):
            count = int((self.aggr_types == aggr).sum())
            n += -(-count // self.batch_size)
        return n
