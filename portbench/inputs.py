"""What a run is made of, from its seed alone: the model's weights, the pool
of host batches and the dropout stream's seed.  What each holds is the
model's (`models/<model>.py`); the batch functions here are the PhysVerb
model's.

Weights are drawn on the device in two calls (one of uniforms, one of
normals) and cut into leaves: fan-in uniform for Linear and convolution
weights and biases, Xavier-uniform packed attention projections with zero
biases, LayerNorm weights 1 + 0.1 N(0, 1) and biases 0.05 N(0, 1) (with the
initial 1 and 0 the Swin tower's pooled features sum to about 1e-6 and the
fusion's zero-row mask would be decided by rounding), BatchNorm at 1 and 0
with identity statistics, and the Swin bias tables from a normal with std
0.02 truncated at two standard deviations.

A batch has the layout and dtypes the program's loader yields
(`data/avabos.py` `build_batch`): float32 data, an all-ones `present`, int32
labels, float32 label masks and an all-ones `sample_mask`.  Audio is
N(0, 0.1) noise over the whole clip; text is N(0, 1) token embeddings whose
tail past a length drawn from [text_min_tokens, text_tokens] is zero (padded
tokens, which the fusion masks); video frames are uniform in [0, 1).
"""

import math

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def subseed(seed: int, salt: int) -> int:
    """A generator seed for one use of the run's seed."""
    return (int(seed) * 1_000_003 + salt * 7_919) & _MASK63


WEIGHTS, BATCHES, DRAWS = 1, 2, 3


def make_weights(spec, seed: int, device):
    """{name: float32 tensor} for `spec` (a model's `parameter_spec`)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, WEIGHTS))
    n_uniform = sum(math.prod(shape) for _, shape, init in spec
                    if isinstance(init, tuple) or init == "bias_table")
    n_normal = sum(math.prod(shape) for _, shape, init in spec
                   if init in ("norm_weight", "norm_bias"))
    uniform = torch.rand(n_uniform, generator=g, device=device)
    normal = torch.randn(n_normal, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init in spec:
        size = math.prod(shape)
        if isinstance(init, tuple):
            kind, fan = init
            bound = (1.0 / math.sqrt(fan) if kind == "uniform"
                     else math.sqrt(6.0 / fan))
            t = (uniform[iu:iu + size] * 2 - 1) * bound
            iu += size
        elif init == "bias_table":
            # normal(0, 0.02) truncated to +-0.04 by its inverse CDF
            lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2, 2))
            u = lo + uniform[iu:iu + size] * (hi - lo)
            t = torch.erfinv(2 * u - 1) * math.sqrt(2) * 0.02
            iu += size
        elif init in ("norm_weight", "norm_bias"):
            z = normal[inn:inn + size]
            t = 1.0 + 0.1 * z if init == "norm_weight" else 0.05 * z
            inn += size
        elif init == "zeros":
            t = torch.zeros(size, device=device)
        elif init == "ones":
            t = torch.ones(size, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = t.reshape(shape).contiguous()
    return out


def batch_shapes(cfg, modalities, batch: int):
    out = {}
    if "audio" in modalities:
        out["audio"] = (batch, cfg["audio_samples"])
    if "text" in modalities:
        out["text"] = (batch, cfg["text_tokens"], cfg["hidden_size"])
    if "video" in modalities:
        out["video"] = (batch, cfg["video_frames"], cfg["video_size"],
                        cfg["video_size"], 3)
    return out


def make_batch(g, cfg, modalities, batch: int, heads, device):
    """One batch as device tensors, drawn from generator `g`."""
    shapes = batch_shapes(cfg, modalities, batch)
    mods = {}
    for m in sorted(shapes):
        if m == "audio":
            data = torch.randn(shapes[m], generator=g, device=device) * 0.1
        elif m == "text":
            data = torch.randn(shapes[m], generator=g, device=device)
            lengths = torch.randint(cfg["text_min_tokens"],
                                    cfg["text_tokens"] + 1, (batch,),
                                    generator=g, device=device)
            keep = (torch.arange(cfg["text_tokens"], device=device)[None]
                    < lengths[:, None])
            data = data * keep[..., None]
        else:
            data = torch.rand(shapes[m], generator=g, device=device)
        mods[m] = {"data": data,
                   "present": torch.ones(batch, device=device)}
    labels, masks = {}, {}
    for head in heads:
        labels[head] = torch.randint(0, 2, (batch,), generator=g,
                                     device=device, dtype=torch.int32)
        masks[head] = torch.ones(batch, device=device)
    return {"modalities": mods, "labels": labels, "label_mask": masks,
            "sample_mask": torch.ones(batch, device=device)}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_pool(seed: int, count: int, device, draw):
    """`count` batches as host tensors, in pinned memory when `device` is
    a card; each drawn on the device by `draw(generator)` and copied out."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, BATCHES))
    pin = torch.device(device).type == "cuda"
    pool = []
    for _ in range(count):
        on_device = draw(g)
        pool.append(tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=pin).copy_(t), on_device))
        del on_device
    return pool


def as_numpy(batch):
    """The host batch as numpy arrays over the same memory (the loader's
    layout)."""
    return tree_map(lambda t: t.numpy(), batch)


def to_device(batch, device):
    return tree_map(lambda t: t.to(device), batch)


def class_weights(pool, head="phys"):
    """The focal loss's inverse-frequency alpha over the pool's labels of
    `head` (the training entry's rule over its data set's labels)."""
    labels = np.concatenate([b["labels"][head].numpy() for b in pool
                             if head in b["labels"]])
    counts = np.bincount(labels.astype(int), minlength=2).astype(np.float64)
    weights = counts.sum() / np.maximum(counts, 1.0)
    return tuple((weights / weights.sum()).tolist())


def draws_generator(seed: int, device):
    """The dropout stream both sides draw from."""
    return torch.Generator(device=device).manual_seed(subseed(seed, DRAWS))

