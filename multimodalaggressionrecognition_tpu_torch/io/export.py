"""AOT model export: a self-contained serving artifact via torch.export
(the JAX package's io/export.py).

`export_predictor` runs `torch.export.export` on a Predictor's whole
forward (`serve.ServingForward`): the presence masks, the compute-dtype
casts and the int8 dequantization or w8a8 products are in the graph, and
the weights are baked into the program (an int8 Predictor exports int8
weights, a ~4x smaller artifact).  The batch size is fixed, as in JAX:
there are no dynamic dimensions.

The port's kernels stay in the graph as the `mar_torch::framed_conv1d`,
`mar_torch::window_attention` and `mar_torch::roll` custom ops (K1, K2,
K4; ops/cuda/), so an artifact scored on the card launches them, and on
the CPU runs their plain versions.  Loading an artifact therefore needs
the op registry, which `ExportedPredictor` imports; no model class is
needed.  (JAX's artifact needs no code of the package at all.)

torch.export bakes the tracing device into the program (factory ops,
tensor constants, the weights).  `platforms` lists the devices the
artifact may be scored on; `ExportedPredictor` moves a program exported on
one to another with `torch.export.passes.move_to_device_pass`.

Format: a directory holding `model.pt2` (`torch.export.save`) and
`meta.json` (the JAX meta's fields: format, batch size, platforms,
per-modality clip shapes, head -> class counts; and the exporting device).
"""

import json
import os
import warnings
from typing import Dict

import numpy as np
import torch

from ..serve import ScorerBase, data_groups, resolve_device

FORMAT = "mar-torch-export-v1"
ARTIFACT = "model.pt2"
_META = "meta.json"
PLATFORMS = ("cpu", "cuda")


def _import_ops():
    """Register the `mar_torch::` ops an artifact's graph calls."""
    from ..ops.cuda import (framed_conv, roll, self_attention,  # noqa: F401
                            window_attention)


def export_predictor(predictor, example_modalities: Dict[str, np.ndarray],
                     out_dir: str, platforms=PLATFORMS) -> dict:
    """Export `predictor`'s forward (weights baked in) under `out_dir`.
    `example_modalities`: {name: (1, *clip_shape)} arrays, what
    `Predictor.warmup` takes.  Returns the meta dict."""
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of "
                         f"{PLATFORMS}, got {platforms}")
    clip_shapes = {name: tuple(int(d) for d in np.shape(arr)[1:])
                   for name, arr in example_modalities.items()}
    batch = _signature(predictor._pad_batch(example_modalities, 1))
    # one `present` per modality: the program takes each as its own input
    batch = {m: {k: v.clone() for k, v in leaf.items()}
             for m, leaf in batch.items()}
    with torch.no_grad(), warnings.catch_warnings():
        # a live forward first: modules that cache constants on first use
        # (the Swin's masks and indices) must not cache traced ones
        out = predictor.serving(batch)
        # an RNN re-lists its weights when they change, as they do for the
        # trace; the list is rebuilt at each call, not state to export
        warnings.filterwarnings(
            "ignore", message=r"The tensor attributes .*_flat_weights")
        program = torch.export.export(predictor.serving, (batch,),
                                      strict=False)
    # the traced batch is no part of the model (and a tri-modal b8 one is
    # 154 MB of frames): the artifact keeps the program and its weights
    program.example_inputs = None
    meta = {"format": FORMAT,
            "batch_size": int(predictor.batch_size),
            "platforms": list(platforms),
            "exported_on": predictor.device.type,
            "clip_shapes": {k: list(v) for k, v in clip_shapes.items()},
            "heads": {head: int(v.shape[-1]) for head, v in out.items()}}
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT))
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _signature(batch):
    """A batch in the program's input order: modalities sorted, each
    {"data", "present"}.  An exported program flattens its dict input in
    insertion order and checks each leaf against the traced one, so a
    caller's order (the micro-batcher merges by a set) must not leak in."""
    return {m: {"data": batch[m]["data"], "present": batch[m]["present"]}
            for m in sorted(batch)}


def graph_ops(program) -> set:
    """The `namespace::name` of every operator a program's graph calls."""
    return {n.target.name().split(".")[0]
            for n in program.graph.nodes
            if n.op == "call_function" and hasattr(n.target, "name")}


class ExportedPredictor(ScorerBase):
    """Score an exported artifact: the same surface as `serve.Predictor`
    (predict / batch_size / heads / modalities / clip_shapes), so
    `MicroBatcher` and the serving daemon run on it unchanged, with no
    model class loaded."""

    def __init__(self, path: str, device="cuda", devices=None,
                 model_parallelism: int = 1):
        """`devices`: a list of devices to serve data-parallel, as
        `serve.Predictor(devices=...)`: the artifact is loaded once for
        each (moved there on load), and the batch split evenly over them.
        An artifact's batch is fixed, so each replica scores the artifact's
        batch and the scorer's is len(devices) times it (JAX's sharded
        call splits the artifact's own batch instead).  Under
        `model_parallelism` tp the devices form `serve.Predictor`'s data
        groups and the artifact is served on each group's first device:
        its weights are baked in, so only the batch is split, as JAX
        passes its exported call the data sharding alone."""
        devices = [g[0] for g in data_groups(devices, device,
                                             model_parallelism)]
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{path!r} is not a {FORMAT} artifact "
                f"(format={meta.get('format')!r})")
        for d in map(torch.device, devices or [device]):
            if d.type not in meta["platforms"]:
                raise ValueError(
                    f"artifact was exported for platforms "
                    f"{meta['platforms']}, not {d.type!r}; re-export with "
                    f"--platforms {d.type}")
        self.devices = tuple(devices)
        self.device = (self.devices[0] if self.devices
                       else resolve_device(device))
        _import_ops()
        self._modules = []
        for d in self.devices or (self.device,):
            program = torch.export.load(os.path.join(path, ARTIFACT))
            if meta["exported_on"] != str(d):
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, d)
            self._modules.append(program.module())
            if len(self._modules) == 1:
                self.program = program
        self._module = self._modules[0]
        self.meta = meta
        self.batch_size = int(meta["batch_size"]) * max(len(self.devices), 1)
        self.heads = sorted(meta["heads"])
        self.head_classes = {k: int(v) for k, v in meta["heads"].items()}
        self.modalities = sorted(meta["clip_shapes"])
        self.clip_shapes = {k: tuple(v)
                            for k, v in meta["clip_shapes"].items()}

    @torch.no_grad()
    def _forward(self, batch):
        return self._module(_signature(batch))

    @torch.no_grad()
    def _replica_forward(self, i, batch):
        return self._modules[i](_signature(batch))

    def warmup(self):
        """Score zeros once, so the first real request does not pay the
        kernels' first launch behind a listening server."""
        self.predict({m: np.zeros((1, *self.clip_shapes[m]), np.float32)
                      for m in self.modalities})
        for device in self.devices or (self.device,):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return self
