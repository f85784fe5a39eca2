"""Training state (the JAX package's train/state.py): the model, its
optimizer, the step count and the optional EMA shadow of the parameters;
and the optimizer chain of the JAX package's `cli/common.make_optimizer`.

The chain is optax's: `MultiSteps(chain(clip_by_global_norm,
adam | adamw(schedule)))`, each link optional.

- schedule: constant, cosine (`optax.cosine_decay_schedule`, alpha 0) or
  exponential (`optax.exponential_decay`, not staircase), with a linear
  warmup from 0 joined in front (`optax.join_schedules`).  The rate of an
  update is schedule(count), count the updates already applied, so the
  first warmup update has rate 0;
- Adam (`optax.adam`: betas 0.9, 0.999, eps 1e-8 outside the square root,
  bias-corrected) or, with a weight decay, AdamW (decoupled, on every
  optimized parameter as optax's default mask; torch.optim.AdamW computes
  the same `p - lr * (adam + wd * p)`);
- clipping by the global norm of the (mean) gradient, to optax's formula
  `g / norm * max_norm` when norm >= max_norm (no epsilon, unlike
  `torch.nn.utils.clip_grad_norm_`);
- accumulation (`optax.MultiSteps`): the running mean of k micro-batch
  gradients, `acc + (g - acc) / (i + 1)`, and one update every k-th step.

On a data-parallel mesh the optimizer sums the gradients over the data
group by hand, in one flat all-reduce per dtype, once per update (after
accumulation: the mean of the micro-batch gradients is linear, so one
reduce of it equals reducing every micro-batch, and sends k times fewer
bytes), before clipping.  Not DDP: the optimizer keeps every gradient as
a tensor (optax's zero gradients), accumulation lives here, and bf16 and
EMA steps run the model through `functional_call`, none of which DDP's
module wrapper sees.  Under tensor parallelism the global norm sums the
split leaves' squares over the tp group and counts each replicated leaf
once; Adam's moments live on the shards.

Frozen parameters (requires_grad False) stay out of the optimizer.  The JAX
package freezes a tower with stop_gradient instead, so its AdamW also
decays the frozen tower's weights; the port never moves them.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"  # constant | cosine | exponential
    lr_decay_steps: int = 10000
    lr_decay_rate: float = 0.95
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0  # 0: no clipping
    weight_decay: float = 0.0  # 0: Adam; else AdamW
    grad_accum_steps: int = 1

    def __post_init__(self):
        if self.lr_schedule not in ("constant", "cosine", "exponential"):
            raise ValueError(f"lr_schedule must be constant, cosine or "
                             f"exponential, got {self.lr_schedule!r}")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")

    def _tail(self, count: int) -> float:
        lr = self.learning_rate
        if self.lr_schedule == "cosine":
            frac = min(count, self.lr_decay_steps) / self.lr_decay_steps
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        if self.lr_schedule == "exponential":
            if count <= 0:
                return lr
            return lr * self.lr_decay_rate ** (count / self.lr_decay_steps)
        return lr

    def schedule(self, count: int) -> float:
        """The learning rate of the update made after `count` updates."""
        w = self.warmup_steps
        if w > 0:
            if count < w:
                return self.learning_rate * count / w
            count -= w
        return self._tail(count)


def adam(params, learning_rate: float, weight_decay: float = 0.0):
    """optax.adam's formula (AdamW's with a weight decay): betas (0.9,
    0.999), eps 1e-8 outside the square root, bias-corrected."""
    kw = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def clip_by_global_norm_(grads, max_norm: float, params=None, mesh=None):
    """optax.clip_by_global_norm in place: g / norm * max_norm for every g
    when the global norm is >= max_norm; returns the norm.  With a
    tensor-parallel `mesh`, `params` (grads' parameters) say which
    gradients are shards."""
    if mesh is not None and mesh.tp > 1:
        from ..parallel.sharding_rules import clip_norm_squares

        norm = clip_norm_squares(grads, params, mesh).sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """The optimizer chain over `params` (OptimizerConfig).  `step()` is
    called once per micro-batch after the backward, with every parameter's
    gradient filled, and returns whether it updated the parameters."""

    def __init__(self, params, cfg: OptimizerConfig, mesh=None):
        self.params = list(params)
        self.cfg = cfg
        self.mesh = mesh  # parallel.mesh.Mesh: sum gradients over dp
        self.inner = adam(self.params, cfg.learning_rate, cfg.weight_decay)
        self.updates = 0  # updates applied (optax's count)
        self.micro = 0  # micro-batches in the running mean
        self.acc = None  # the running mean, one tensor per parameter

    @property
    def param_groups(self):
        """The optimized parameters and their hyperparameters (torch's
        optimizer's groups)."""
        return self.inner.param_groups

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=False)

    def step(self) -> bool:
        grads = [p.grad for p in self.params]
        k = self.cfg.grad_accum_steps
        if k > 1:
            with torch.no_grad():
                if self.acc is None:
                    self.acc = [torch.zeros_like(p) for p in self.params]
                diff = torch._foreach_sub(grads, self.acc)
                torch._foreach_div_(diff, float(self.micro + 1))
                torch._foreach_add_(self.acc, diff)
            if self.micro < k - 1:
                self.micro += 1
                return False
            with torch.no_grad():
                for g, a in zip(grads, self.acc):
                    g.copy_(a)
                    a.zero_()
            self.micro = 0
        if self.mesh is not None and self.mesh.dp > 1:
            self.reduce_gradients(grads)
        if self.cfg.grad_clip_norm > 0:
            with torch.no_grad():
                clip_by_global_norm_(grads, self.cfg.grad_clip_norm,
                                     self.params, self.mesh)
        lr = self.cfg.schedule(self.updates)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.updates += 1
        return True

    @torch.no_grad()
    def reduce_gradients(self, grads):
        """Sum `grads` over the data group, in place: one flat buffer per
        dtype, one all-reduce each."""
        from ..parallel.mesh import all_reduce_

        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            all_reduce_(flat, self.mesh.dp_group)
            torch._foreach_copy_(group, [v.view_as(g) for v, g in zip(
                flat.split([g.numel() for g in group]), group)])

    def state_dict(self) -> dict:
        out = {"adam": self.inner.state_dict(), "updates": self.updates}
        if self.acc is not None:
            out["accumulation"] = {"micro": self.micro,
                                   "grads": [a.clone() for a in self.acc]}
        return out

    def load_state_dict(self, sd: dict):
        """Restore the moments and counters of `state_dict()`; the
        hyperparameters stay this chain's own (a run saved with another
        schedule, weight decay or accumulation resumes under the current
        ones)."""
        own = [{k: v for k, v in g.items() if k != "params"}
               for g in self.inner.param_groups]
        self.inner.load_state_dict(sd["adam"])
        for group, hyper in zip(self.inner.param_groups, own):
            group.update(hyper)
        self.updates = int(sd["updates"])
        accum = sd.get("accumulation")
        self.micro, self.acc = 0, None
        if accum is not None and self.cfg.grad_accum_steps > 1:
            self.micro = int(accum["micro"])
            self.acc = [a.to(p.device) for a, p in zip(accum["grads"],
                                                       self.params)]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0  # micro-batches trained
    # EMA shadow of the trainable parameters ({name: tensor}), or None:
    # d * e + (1 - d) * p after each optimizer update; eval and serving use
    # it (eval_params), the BatchNorm statistics stay live
    ema: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    # parallel.mesh.Mesh of a data- or tensor-parallel run, or None
    mesh: Optional[object] = None

    def dp_group(self):
        """The data group the step's losses and gradients sum over."""
        return None if self.mesh is None else self.mesh.dp_group

    @torch.no_grad()
    def update_ema(self):
        if self.ema is None:
            return
        d = self.ema_decay
        names = list(self.ema)
        params = dict(self.model.named_parameters())
        shadow = [self.ema[n] for n in names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, [params[n] for n in names], alpha=1.0 - d)

    def eval_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The parameters to evaluate and serve with, where they differ from
        the live ones: the EMA shadow, or None."""
        return self.ema

    def start_ema(self, decay: float, shadow=None):
        """Track an EMA at `decay`, seeded from `shadow` ({name: tensor})
        where it has the parameter, else from the live parameter."""
        self.ema_decay = float(decay)
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        shadow = shadow or {}
        self.ema = {n: (shadow[n].to(p.device, p.dtype) if n in shadow
                        else p.detach().clone())
                    for n, p in params.items()}


def create_train_state(model, optimizer: OptimizerConfig, device,
                       ema_decay: float = 0.0, mesh=None) -> TrainState:
    """Move `model` to `device` and give every trainable parameter an
    optimizer slot and a zero gradient.  optax updates
    every parameter on every step, a zero gradient included (Adam's moments
    still decay), so gradients are kept as zeros rather than None between
    steps; frozen parameters (requires_grad False) are not optimized and
    never move, as optax leaves a parameter whose gradient is always zero.
    `ema_decay` > 0 starts the EMA shadow at the initial parameters.  On a
    `mesh` the model is placed first (parallel/sharding_rules.place_params:
    tensor-parallel shards, global BatchNorm statistics, global-batch
    draws), so the optimizer and the shadow hold shards."""
    model = model.to(device)
    if mesh is not None:
        from ..parallel.sharding_rules import place_params

        place_params(model, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = torch.zeros_like(p)
    state = TrainState(model=model,
                       optimizer=Optimizer(params, optimizer, mesh),
                       mesh=mesh)
    if ema_decay > 0:
        state.start_ema(ema_decay)
    return state
