"""Train-mode randomness with explicit generators: the dropouts, stochastic
depth, and gradient checkpointing that replays their draws.

Every stochastic module draws its keep mask from its own `generator`
attribute (a `torch.Generator` on the input's device; None means torch's
default generator), never from hidden global state, so a trainer seeds a
run by handing one generator to the whole model (`set_generator`).  A kept
element is scaled by 1/keep and a dropped one is 0, as in the JAX package
(`jnp.where(mask, x / keep, 0)`).  In eval mode, or at rate 0, each module
is the identity.

`torch.utils.checkpoint` replays torch's global RNG states in its
recompute, not an explicit generator's: `checkpoint` below also rewinds the
generators of the checkpointed module, so the recompute draws the same
masks as the forward.
"""

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint


class Stochastic(nn.Module):
    """Base of the modules that draw a keep mask: `rate` is the drop
    probability, `noise_shape(x)` the mask's shape (broadcast over x)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def noise_shape(self, x):
        return x.shape

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(self.noise_shape(x), generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class Dropout(Stochastic):
    """Element-wise dropout (flax nn.Dropout / torch nn.Dropout)."""


def set_generator(model: nn.Module, generator) -> nn.Module:
    """Make every stochastic module of `model` draw from `generator`."""
    for m in model.modules():
        if isinstance(m, Stochastic):
            m.generator = generator
    return model


def checkpoint(module: nn.Module, *args):
    """torch.utils.checkpoint of module(*args) whose recompute draws the
    same masks from the explicit generators of module's stochastic
    submodules as the forward did."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Stochastic) and m.generator is not None
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

    return _checkpoint(module, *args, use_reentrant=False,
                       context_fn=lambda: (forward_ctx(), recompute_ctx()))
