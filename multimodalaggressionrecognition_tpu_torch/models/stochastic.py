"""Train-mode randomness with explicit generators: the dropouts, stochastic
depth, and gradient checkpointing that replays their draws.

Every random module (a `Random`: the dropouts, stochastic depth, the
spectrogram masks of ops/stft.py) draws from its own `generator` attribute
(a `torch.Generator` on the input's device; None means torch's default
generator), never from hidden global state, so a trainer seeds a run by
handing one generator to the whole model (`set_generator`).  A kept
element is scaled by 1/keep and a dropped one is 0, as in the JAX package
(`jnp.where(mask, x / keep, 0)`).  In eval mode, or at rate 0, each module
is the identity.

On a data-parallel mesh (parallel/sharding_rules.place_params) a mask is
drawn for the global batch and each rank keeps its own rows
(`batch_shard`); a tensor-parallel layer also keeps its own columns or
heads (`shards`).  So every rank's generator stays in lockstep, and a
multi-rank step draws what the one-rank step draws, as JAX's one draw
over a sharded array does.

`torch.utils.checkpoint` replays torch's global RNG states in its
recompute, not an explicit generator's: `checkpoint` below also rewinds the
generators of the checkpointed module, so the recompute draws the same
masks as the forward.  Its policy "dots" (the JAX package's
`dots_with_no_batch_dims_saveable`) saves the outputs of the 2-D products
`F.linear` lowers to (`aten.mm`, `aten.addmm`) and recomputes the rest,
batched products and custom ops (the window-attention and roll kernels)
among them.
"""

import contextlib

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)
from torch.utils.checkpoint import checkpoint as _checkpoint

REMAT_POLICIES = ("none", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class Random(nn.Module):
    """Base of the modules that draw in train mode, from `generator`;
    `batch_shard` (index, count) says which block of the global batch's
    rows this rank holds (None: all)."""

    def __init__(self):
        super().__init__()
        self.generator = None
        self.batch_shard = None

    def draw(self, shape, device, shards=()):
        """Uniforms of `shape`: this rank's block of one draw of the global
        shape.  `shards` adds (axis, index, count) splits to the batch's;
        an axis of size 1 (broadcast) is drawn whole."""
        splits = list(shards)
        if self.batch_shard is not None:
            splits.append((0, *self.batch_shard))
        shape = list(shape)
        full = list(shape)
        splits = [(axis % len(shape), i, n) for axis, i, n in splits
                  if n > 1 and shape[axis] != 1]
        for axis, _, n in splits:
            full[axis] *= n
        u = torch.rand(full, generator=self.generator, device=device)
        for axis, i, _ in splits:
            u = u.narrow(axis, i * shape[axis], shape[axis])
        return u


class Stochastic(Random):
    """Base of the modules that draw a keep mask: `rate` is the drop
    probability, `noise_shape(x)` the mask's shape (broadcast over x)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def noise_shape(self, x):
        return x.shape

    def forward(self, x, shards=()):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = self.draw(self.noise_shape(x), x.device, shards) < keep
        return torch.where(mask, x / keep, 0.0)


class Dropout(Stochastic):
    """Element-wise dropout (flax nn.Dropout / torch nn.Dropout)."""


def set_generator(model: nn.Module, generator) -> nn.Module:
    """Make every random module of `model` draw from `generator`."""
    for m in model.modules():
        if isinstance(m, Random):
            m.generator = generator
    return model


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def checkpoint(module: nn.Module, *args, policy: str = "none"):
    """torch.utils.checkpoint of module(*args) whose recompute draws the
    same masks from the explicit generators of module's stochastic
    submodules as the forward did, and runs on the same parameters: the
    tensors module holds now (a caller's `functional_call` may have put
    bf16 casts in place of them, train/steps.py) are handed to the
    checkpointed call as inputs, since the recompute runs in the backward,
    after such a substitution has ended.  `policy` "none" saves nothing
    inside; "dots" saves the 2-D products' outputs (see the module doc)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Random) and m.generator is not None
                 }.values())
    before = []

    @contextlib.contextmanager
    def forward_ctx():
        before[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, before):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    def contexts():
        if policy == "none":
            return forward_ctx(), recompute_ctx()
        save, replay = create_selective_checkpoint_contexts(_save_dots)
        return (_entered(forward_ctx(), save),
                _entered(recompute_ctx(), replay))

    params = dict(module.named_parameters())
    names, n_args = list(params), len(args)

    def run(*flat):
        return functional_call(module, dict(zip(names, flat[n_args:])),
                               flat[:n_args])

    return _checkpoint(run, *args, *params.values(), use_reentrant=False,
                       context_fn=contexts)
