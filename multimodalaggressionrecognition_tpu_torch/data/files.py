"""Per-modality file datasets with filename-encoded labels (a copy of the JAX
package's data/files.py, which the port does not import).

The single-modality training paths read flat directories of artifacts
whose label is the last `_`-token of the stem (`..._AGGR.npy`,
`..._NOAGGR.wav`):
- `.npy` feature sequences (text embeddings, precomputed features);
- `.pt` waveforms or videos;
- `.wav` audio, mono, resampled to 16 kHz on the host (ops/resample.py).

`FilenameLabelSource` loads them by extension, applies an optional host
transform, and `build_batch` emits the trainer's batch protocol with one
label per head.  WAVs decode with scipy and numpy, or with the native
C++ loader (data/native.py) under `MAR_USE_NATIVE_WAV=1` or where scipy
cannot be imported.
"""

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

LABEL_DICT = {"NOAGGR": 0, "AGGR": 1}


def read_names_file(path: str):
    """An order-pinned file list (the reference's `train_names.txt`):
    newline-separated names, blank lines dropped, each name kept byte for
    byte except its line ending."""
    with open(path, "r", encoding="utf-8", newline="") as fd:
        lines = [line.rstrip("\r\n") for line in fd.read().split("\n")]
    return [line for line in lines if line.strip()]


def _load_npy(path):
    return np.load(path).astype(np.float32)


def _load_pt(path):
    import torch

    x = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(x, dtype=np.float32)


def _load_wav(path, target_rate=16000):
    from scipy.io import wavfile

    from ..ops.resample import resample_poly_np

    rate, raw = wavfile.read(path)
    data = np.asarray(raw, np.float32)
    if data.ndim == 2:  # to mono
        data = data.mean(axis=1)
    if np.issubdtype(np.asarray(raw).dtype, np.integer):
        data = data / 32768.0
    if rate != target_rate:
        data = resample_poly_np(data, rate, target_rate)
    return data.astype(np.float32)


class FilenameLabelSource:
    def __init__(self, root: str, modality: str,
                 transform: Optional[Callable] = None,
                 label_dict: Dict[str, int] = None,
                 extensions=(".npy", ".pt", ".wav"),
                 target_rate: int = 16000,
                 files: Optional[Sequence[str]] = None,
                 heads: Sequence[str] = ("main",)):
        self.root = root
        self.modality = modality
        self.transform = transform
        self.label_dict = dict(label_dict or LABEL_DICT)
        self.target_rate = target_rate
        self.heads = tuple(heads)  # multi-head models see the label per head
        self.extensions = tuple(extensions)
        self._pinned = files is not None
        if files is None:
            files = sorted(f for f in os.listdir(root)
                           if os.path.splitext(f)[1] in extensions)
        self.files = list(files)
        if self._pinned:  # a pinned list fails here, not mid-epoch
            self._validate_pinned(root)

    def _validate_pinned(self, root):
        """Pinned names must exist in `root` and carry a loadable
        extension."""
        bad_ext = [f for f in self.files
                   if os.path.splitext(f)[1] not in self.extensions]
        if bad_ext:
            raise ValueError(
                f"{len(bad_ext)} pinned name(s) with unsupported extension "
                f"(supported: {self.extensions}): {bad_ext[:5]}")
        missing = [f for f in self.files
                   if not os.path.isfile(os.path.join(root, f))]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} pinned name(s) absent from {root}: "
                f"{missing[:5]}")

    def __len__(self):
        return len(self.files)

    def set_root(self, root: str):
        """Repoint the data directory; a pinned list is validated against
        the new one first."""
        if self._pinned:
            self._validate_pinned(root)
        self.root = root

    def labels(self):
        return np.asarray([self._label(f) for f in self.files])

    def _label(self, fname):
        stem = os.path.splitext(fname)[0]
        return self.label_dict[stem.split("_")[-1]]

    def load(self, idx: int):
        fname = self.files[idx]
        path = os.path.join(self.root, fname)
        ext = os.path.splitext(fname)[1]
        if ext == ".npy":
            x = _load_npy(path)
        elif ext == ".pt":
            x = _load_pt(path)
        elif ext == ".wav":
            x = self._wav(path)
        else:
            raise ValueError(f"unsupported extension {ext}")
        if self.transform is not None:
            x = self.transform(x)
        return x, self._label(fname)

    def _wav(self, path):
        """WAV decode + resample: scipy and numpy by default; the native
        library (data/native.py) under MAR_USE_NATIVE_WAV=1 or when scipy
        cannot be imported, and numpy again where the library is
        unavailable."""
        if os.environ.get("MAR_USE_NATIVE_WAV") != "1":
            try:
                return _load_wav(path, self.target_rate)
            except ImportError:
                pass
        from . import native

        if native.available():
            from scipy.io import wavfile

            rate, data = wavfile.read(path, mmap=True)
            n = len(data)
            target = (n if rate == self.target_rate
                      else -(-self.target_rate * n // rate))
            return native.wav_read(path, target_len=target,
                                   target_rate=self.target_rate)
        return _load_wav(path, self.target_rate)

    def build_batch(self, indices, pad_to: Optional[int] = None):
        """A fixed-shape batch: padded to `pad_to` rows by repeating the
        first sample with mask 0."""
        samples = [self.load(i) for i in indices]
        n = len(samples)
        total = pad_to or n
        mask = np.zeros((total,), np.float32)
        mask[:n] = 1.0
        while len(samples) < total:
            samples.append(samples[0])
        data = np.stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        return {
            "modalities": {self.modality: {"data": data, "present": mask}},
            "labels": {h: labels for h in self.heads},
            "label_mask": {h: mask.copy() for h in self.heads},
            "sample_mask": mask,
        }


class RandomBatchSampler:
    """Shuffled fixed-size batches for single-modality sources: epoch e
    shuffles with seed + e.  The Trainer pins `set_epoch(epoch)` before each
    epoch, so a run resumed mid-epoch shuffles like the uninterrupted one;
    standalone iteration still counts epochs by iterations."""

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        for i in range(0, self.num_samples, self.batch_size):
            yield idx[i:i + self.batch_size].tolist()
        self.epoch += 1

    def __len__(self):
        return -(-self.num_samples // self.batch_size)
