"""Audio+text two-tower training (the JAX package's cli/train_audio_text.py).

The intervals table's rows with both verbal modalities ('verb',
'phys&verb'): the padded waveform and the RuBERT token embeddings ->
AudioTextualModel: the CNN1D audio tower + Linear(512 -> 768) (its stem
through the framed-conv kernel), a 2-layer transformer text tower, each
mean-pooled, concatenated, and an MLP -> CE on the single head 'main' (the
rows' 'verb' label), Adam and best-UAR checkpoints.  Runs on CUDA unless
--device cpu.  The JAX entry's `--pallas_stem` is not carried over: on CUDA
the stem always runs the kernel.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_audio_text \\
      --dataset_root data/avabos --synthetic
"""

from dataclasses import dataclass

from torch import nn

from ..data.avabos import AGGR_PRESENCE, MultimodalSource, split_by_clusters
from ..models.audiotext import AudioTextualModel
from ..models.cnn1d import AudioCnn1DExtractorWrapper
from ..models.layers import TransformerEncoder
from .common import (TrainConfig, build_trainer, ensure_dataset,
                     parse_config, run_training)


@dataclass
class AudioTextConfig(TrainConfig):
    model_name: str = "audio_text"
    hidden_size: int = 768
    audio_samples: int = 80000
    text_tokens: int = 48


class _Encoder(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.encoder = TransformerEncoder(hidden_size, 8, 2)


class TextFeatures(nn.Module):
    """(B, T, H) tokens -> (B, T, H) features of a 2-layer, 8-head
    transformer encoder: the JAX entry's TextFeatures, whose `inner`
    TransformerSequenceClassifier only ever gives features, so that flax
    made its encoder and no classifier layers."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.inner = _Encoder(hidden_size)

    def forward(self, x):
        return self.inner.encoder(x)


class MainHead(nn.Module):
    """modalities -> {'main': inner(modalities)}."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, modalities):
        return {"main": self.inner(modalities)}


def make_model(cfg):
    return MainHead(AudioTextualModel(
        audio_extractor=AudioCnn1DExtractorWrapper(cfg.hidden_size),
        text_extractor=TextFeatures(cfg.hidden_size),
        hidden_size=cfg.hidden_size, class_num=2))


class PairSource(MultimodalSource):
    """Batches with both audio and text, labelled by 'verb' under the head
    'main'; a batch without either is dropped (None)."""

    def build_batch(self, indices, pad_to=None):
        b = super().build_batch(indices, pad_to)
        if b is None or "audio" not in b["modalities"] \
                or "text" not in b["modalities"]:
            return None
        b["labels"] = {"main": b["labels"]["verb"]}
        b["label_mask"] = {"main": b["label_mask"]["verb"]}
        return b

    def batch_is_empty(self, indices):
        """True iff build_batch(indices) gives None, from the table alone:
        batches are aggr_type-homogeneous, and either modality absent
        drops the batch."""
        row = self.df.iloc[indices[0]]
        present = set(AGGR_PRESENCE[row["aggr_type"]]) & set(self.modalities)
        return not {"audio", "text"} <= present


def make_loaders(cfg):
    from ..data.pipeline import BatchLoader
    from ..data.sampler import AggrBatchSampler
    from ..data.transforms import pad_audio, pad_text

    df, split = ensure_dataset(cfg)
    df = df[df["aggr_type"].isin(["verb", "phys&verb"])]
    loaders = []
    for clusters, shuffle in ((split["train"], True), (split["test"], False)):
        d = split_by_clusters(df, clusters)
        src = PairSource(d, cfg.dataset_root, ("audio", "text"),
                         transforms={"audio": pad_audio(cfg.audio_samples),
                                     "text": pad_text(cfg.text_tokens)})
        sampler = AggrBatchSampler(d["aggr_type"].to_numpy(), cfg.batch_size,
                                   shuffle=shuffle, seed=cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(AudioTextConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    train_loader, test_loader = make_loaders(cfg)
    trainer = build_trainer(cfg, seeded_init_(make_model(cfg), cfg.seed),
                            {"main": LossSpec("ce")}, train_loader,
                            test_loader)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py)."""
    return {"audio": (cfg.audio_samples,),
            "text": (cfg.text_tokens, cfg.hidden_size)}


if __name__ == "__main__":
    main()
