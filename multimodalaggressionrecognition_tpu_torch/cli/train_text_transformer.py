"""Text transformer training (the JAX package's cli/train_text_transformer.py).

RuBERT token-embedding sequences (padded to 48 x 768) -> a 2-layer
transformer encoder -> mean-pool classifier -> CE on the single head
'main', Adam and best-UAR checkpoints.  It reads a flat directory of
`*_LABEL.npy` files (`--files_root`), or else the intervals table, its
rows with verbal aggression ('verb', 'phys&verb') and their 'verb' label.
Runs on CUDA unless --device cpu.

  python -m multimodalaggressionrecognition_tpu_torch.cli.train_text_transformer \
      --dataset_root data/avabos --synthetic
"""

import os
from dataclasses import dataclass

from ..data.avabos import MultimodalSource, split_by_clusters
from .common import (NamesPinConfig, build_trainer, ensure_dataset,
                     parse_config, pinned_files, run_training)


@dataclass
class TextConfig(NamesPinConfig):
    model_name: str = "ConversationalRuBERT"
    files_root: str = ""               # the flat-directory mode
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 8
    text_tokens: int = 48


def make_model(cfg):
    from ..models.heads import TransformerSequenceClassifier
    from ..train.steps import SingleHeadAdapter

    return SingleHeadAdapter(
        TransformerSequenceClassifier(
            class_num=2, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads),
        modality="text", head="main")


class TextOnlySource(MultimodalSource):
    """The intervals table's text clips, labelled by their 'verb' label
    under the head 'main'."""

    def build_batch(self, indices, pad_to=None):
        b = super().build_batch(indices, pad_to)
        if b is None:
            return None
        b["labels"] = {"main": b["labels"]["verb"]}
        b["label_mask"] = {"main": b["label_mask"]["verb"]}
        return b


def make_loaders(cfg):
    from ..data.pipeline import BatchLoader
    from ..data.transforms import pad_text

    if cfg.files_root:
        from ..data.files import FilenameLabelSource, RandomBatchSampler

        loaders = []
        for sub, shuffle in (("train", True), ("test", False)):
            src = FilenameLabelSource(os.path.join(cfg.files_root, sub), "text",
                                      transform=pad_text(cfg.text_tokens),
                                      files=pinned_files(cfg, sub))
            sampler = RandomBatchSampler(len(src), cfg.batch_size, shuffle,
                                         cfg.seed)
            loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                       num_threads=cfg.num_threads))
        return loaders

    from ..data.sampler import AggrBatchSampler

    df, split = ensure_dataset(cfg)
    df = df[df["aggr_type"].isin(["verb", "phys&verb"])]
    loaders = []
    for clusters, shuffle in ((split["train"], True), (split["test"], False)):
        d = split_by_clusters(df, clusters)
        src = TextOnlySource(d, cfg.dataset_root, ("text",),
                             transforms={"text": pad_text(cfg.text_tokens)})
        sampler = AggrBatchSampler(d["aggr_type"].to_numpy(), cfg.batch_size,
                                   shuffle=shuffle, seed=cfg.seed)
        loaders.append(BatchLoader(src, sampler, pad_to=cfg.batch_size,
                                   num_threads=cfg.num_threads))
    return loaders


def main(argv=None):
    from ..models.layers import seeded_init_
    from ..serve import resolve_device
    from ..train.steps import LossSpec

    cfg = parse_config(TextConfig, argv)
    resolve_device(cfg.device)  # fail before any data or model work
    train_loader, test_loader = make_loaders(cfg)
    trainer = build_trainer(cfg, seeded_init_(make_model(cfg), cfg.seed),
                            {"main": LossSpec("ce")}, train_loader,
                            test_loader)
    return run_training(cfg, trainer)


def export_spec(cfg):
    """Per-modality clip shapes for export (cli/export_model.py)."""
    return {"text": (cfg.text_tokens, cfg.hidden_size)}


if __name__ == "__main__":
    main()
