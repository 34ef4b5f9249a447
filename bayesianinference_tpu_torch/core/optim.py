"""Adam with optax's update (``optax.adam``), for the type-II maximum
likelihood fits (``engines/gp_classify.py``, ``engines/sparse_gp.py``) and
ChEES's log trajectory length (``ops/chees.py``, an ascent: a step on the
negated gradient).

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   t = t + 1
    params += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

in optax's order of operations, on a dict of tensors.  ``torch.optim.Adam``
folds the bias corrections into the step size and would differ in the
last digits, which compound over a trace.

ADVI (``engines/vi.py``) decays the step size by optax's
``cosine_decay_schedule``; like optax's ``scale_by_schedule`` it reads the
step count before the step increments it, so the first step takes
``schedule(0)``, the full rate.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import math

import torch

__all__ = ["AdamState", "adam_init", "adam_step", "cosine_decay_schedule"]


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()}, count=0)


def adam_step(params, grads, state: AdamState, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8):
    """(new params, new state) after one Adam step on ``grads``."""
    t = state.count + 1
    c1, c2 = 1.0 - b1**t, 1.0 - b2**t
    mu = {k: (1.0 - b1) * grads[k] + b1 * state.mu[k] for k in params}
    nu = {k: (1.0 - b2) * grads[k] ** 2 + b2 * state.nu[k] for k in params}
    new = {k: params[k] + (-learning_rate) * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in params}
    return new, AdamState(mu=mu, nu=nu, count=t)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: step count -> step size,
    ``init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * min(t, T) / T)) + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(float(count), float(decay_steps))
        return init_value * ((1 - alpha) * (0.5 * (1 + math.cos(math.pi * t / decay_steps))) + alpha)

    return schedule
