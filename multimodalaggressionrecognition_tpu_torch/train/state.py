"""Training state (the JAX package's train/state.py): the model, its
optimizer and the step count."""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam's formula: betas (0.9, 0.999), eps 1e-8 outside the
    square root, bias-corrected."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(model, learning_rate: float, device) -> TrainState:
    """Move `model` to `device` and give every trainable parameter an Adam
    slot and a zero gradient.  optax updates every parameter on every step,
    a zero gradient included (Adam's moments still decay), so gradients are
    kept as zeros rather than None between steps; frozen parameters
    (requires_grad False) are not optimized and never move, as optax leaves
    a parameter whose gradient is always zero."""
    model = model.to(device)
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = torch.zeros_like(p)
    return TrainState(model=model, optimizer=adam(params, learning_rate))
