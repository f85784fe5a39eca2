"""AVABOS-style dataset access: intervals table, cluster split, EMPTY protocol
(a copy of the JAX package's data/avabos.py, which the port does not import).

Host-side counterpart of the reference's `MultimodalDataset` /
`MultimodalPhysVerbDataset` (reference datasets.py:443-608):

- a time-intervals table with columns `aggr_type, cluster_id, video_id,
  phys_t1, phys_t2, verb_t1, verb_t2, person_id, phys_aggr_label,
  verb_aggr_label` (datasets.py:477-486);
- artifact paths `verbal/<embed_type>/<name>.npy`, `verbal/pt_waveform/
  <name>.pt`, `physical/video/<name>.pt` with
  name = `c-{cluster}_{video}_{person}_{t1/1000}-{t2/1000}_{label}`
  (datasets.py:513-562);
- presence per `aggr_type`: 'verb' -> audio+text, 'phys' -> video,
  'phys&verb' -> all three; absent modalities are EMPTY (the reference's -1
  stubs + `<modality>_EMPTY` key tags become {0,1} presence masks here);
- labels renamed modality -> aggression type via `modality2aggr`
  (datasets.py:592-608); missing labels carry -1 and a 0 mask.

Decoding stays on the host (numpy / torch-cpu for .pt artifacts); batches are
fixed-shape numpy dicts ready for device upload (data/pipeline.py).  The
table is a pandas DataFrame.
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

LABEL_DICT = {"NOAGGR": 0, "AGGR": 1}
MODALITY2AGGR = {"video": "phys", "text": "verb", "audio": "verb"}
AGGR_PRESENCE = {
    "verb": ("audio", "text"),
    "phys": ("video",),
    "phys&verb": ("audio", "text", "video"),
}


def load_cluster_split(path: str) -> Dict[str, List[int]]:
    """train_test_split.json: {'train': [cluster ids...], 'test': [...]}."""
    with open(path) as f:
        return json.load(f)


def split_by_clusters(df, clusters: Sequence[int]):
    return df[df["cluster_id"].isin(list(clusters))].reset_index(drop=True)


def _fmt_time(t):
    return f"{t / 1000}"


def clip_name(row, kind: str) -> str:
    """kind: 'phys' or 'verb' -> the reference's clip file stem."""
    t1, t2 = (row["phys_t1"], row["phys_t2"]) if kind == "phys" else (
        row["verb_t1"], row["verb_t2"])
    label = row["phys_aggr_label"] if kind == "phys" else row["verb_aggr_label"]
    return (f"c-{row['cluster_id']}_{row['video_id']}_{row['person_id']}_"
            f"{_fmt_time(t1)}-{_fmt_time(t2)}_{label}")


def _load_pt(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True).numpy()


class MultimodalSource:
    """Row -> {modality: array}, labels {'phys','verb'}, presence masks.

    `transforms` maps modality -> callable(np.ndarray) -> np.ndarray applied
    on the host (pad/resize/augment).  Fixed output shapes are the
    transforms' responsibility.  With `text_ids` (a directory name under
    `verbal/`) the text modality is a transcript's int64 token ids, one
    `.npy` a clip, and its transform returns (padded ids, length): the batch
    then carries the text's `lengths` beside its `data`.
    """

    def __init__(self, df, root: str, modalities: Sequence[str],
                 transforms: Optional[Dict] = None,
                 text_embedding_type: str = "ru_conversational_cased_L-12_H-768_A-12_pt_v1_tokens",
                 modality2aggr: Dict[str, str] = None,
                 text_ids: Optional[str] = None):
        self.df = df.reset_index(drop=True)
        self.text_ids = text_ids
        self.root = root
        self.modalities = tuple(modalities)
        self.transforms = transforms or {}
        self.text_embedding_type = text_embedding_type
        self.modality2aggr = dict(modality2aggr or MODALITY2AGGR)

    def __len__(self):
        return len(self.df)

    def aggr_types(self):
        return self.df["aggr_type"].to_numpy()

    def _apply(self, modality, x):
        fn = self.transforms.get(modality)
        return fn(x) if fn is not None else x

    def load_sample(self, idx: int):
        row = self.df.iloc[idx]
        present_modalities = set(AGGR_PRESENCE[row["aggr_type"]]) & set(self.modalities)
        data, present = {}, {}
        labels = {"phys": -1, "verb": -1}
        label_mask = {"phys": 0.0, "verb": 0.0}
        for modality in self.modalities:
            if modality in present_modalities:
                kind = "phys" if modality == "video" else "verb"
                name = clip_name(row, kind)
                if modality == "text" and self.text_ids:
                    x = np.load(os.path.join(self.root, "verbal",
                                             self.text_ids, f"{name}.npy"))
                    x = x.astype(np.int64).reshape(-1)
                elif modality == "text":
                    path = os.path.join(self.root, "verbal",
                                        self.text_embedding_type, f"{name}.npy")
                    x = np.load(path).astype(np.float32)
                elif modality == "audio":
                    path = os.path.join(self.root, "verbal", "pt_waveform",
                                        f"{name}.pt")
                    x = _load_pt(path).astype(np.float32)
                    x = x.reshape(-1)  # (1, L) or (L,)
                else:  # video .pt saved (T, C, H, W) by the reference prep
                    path = os.path.join(self.root, "physical", "video",
                                        f"{name}.pt")
                    x = _load_pt(path).astype(np.float32)
                    if x.ndim == 4 and x.shape[1] in (1, 3):
                        x = x.transpose(0, 2, 3, 1)  # -> (T, H, W, C)
                data[modality] = self._apply(modality, x)
                present[modality] = 1.0
                aggr = self.modality2aggr[modality]
                lbl = row["phys_aggr_label"] if aggr == "phys" else row["verb_aggr_label"]
                labels[aggr] = LABEL_DICT[lbl] if isinstance(lbl, str) else int(lbl)
                label_mask[aggr] = 1.0
            else:
                data[modality] = None
                present[modality] = 0.0
        return data, present, labels, label_mask

    def batch_is_empty(self, indices: Sequence[int]) -> bool:
        """True iff build_batch(indices) would return None (no selected
        modality present), from the intervals table alone (no file I/O):
        BatchLoader.iter_skipping advances a resumed epoch's batch stream
        with it.  Batches are aggr_type-homogeneous, and build_batch keys
        modality inclusion off its first sample."""
        row = self.df.iloc[indices[0]]
        return not (set(AGGR_PRESENCE[row["aggr_type"]])
                    & set(self.modalities))

    def build_batch(self, indices: Sequence[int], pad_to: Optional[int] = None):
        """Fixed-shape numpy batch dict for a homogeneous index batch.

        Returns {'modalities': {name: {'data', 'present'}},
                 'labels': {aggr: (B,)}, 'label_mask': {aggr: (B,)},
                 'sample_mask': (B,)}.
        Partial batches are padded to `pad_to` by repeating the first sample
        with sample_mask 0 (one batch shape per presence pattern).
        Absent modalities are dropped from the dict entirely (static zero
        stubs are generated inside the model).  Returns None when no selected
        modality is present for this batch (an all-EMPTY batch trains
        nothing — the reference fed such batches through and skipped every
        head's loss; dropping them is equivalent and saves the step).
        """
        samples = [self.load_sample(i) for i in indices]
        n = len(samples)
        total = pad_to or n
        sample_mask = np.zeros((total,), np.float32)
        sample_mask[:n] = 1.0
        while len(samples) < total:
            samples.append(samples[0])

        modalities = {}
        for m in self.modalities:
            if samples[0][0][m] is None:
                continue
            pres = np.asarray([s[1][m] for s in samples], np.float32) * sample_mask
            if isinstance(samples[0][0][m], tuple):  # token ids, length
                modalities[m] = {
                    "data": np.stack([s[0][m][0] for s in samples]),
                    "lengths": np.asarray([s[0][m][1] for s in samples],
                                          np.int64),
                    "present": pres}
                continue
            stack = np.stack([s[0][m] for s in samples])
            modalities[m] = {"data": stack, "present": pres}
        labels = {}
        label_mask = {}
        for aggr in ("phys", "verb"):
            lbl = np.asarray([max(s[2][aggr], 0) for s in samples], np.int32)
            msk = np.asarray([s[3][aggr] for s in samples], np.float32) * sample_mask
            if msk.sum() > 0 or any(s[3][aggr] > 0 for s in samples):
                labels[aggr] = lbl
                label_mask[aggr] = msk
        if not modalities:
            return None
        return {"modalities": modalities, "labels": labels,
                "label_mask": label_mask, "sample_mask": sample_mask}
