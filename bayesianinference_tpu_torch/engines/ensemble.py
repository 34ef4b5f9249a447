"""Affine-invariant ensemble sampling, emcee-style (port of
``bayesianinference_tpu.engines.ensemble``).

Gradient-free, with nothing to tune and exact invariance under affine
reparameterization; see :mod:`..ops.ensemble` for the moves.  Walkers are
the batch axis, so hundreds to thousands of them cost little more than a
few.  Box-bounded problems are sampled in unconstrained coordinates
through :func:`..core.transforms.box_bijection`, as in the HMC engine.
The JAX package's jit and ``lru_cache`` program caches are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from ..core.containers import WeightedSamples
from ..core.device import as_float_on
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.ensemble import ensemble_draws, ensemble_init, ensemble_sweep
from .hmc import z_space_density

__all__ = ["EnsembleResult", "ensemble_sample"]


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Output of :func:`ensemble_sample`."""

    samples: torch.Tensor  # [num_walkers, num_samples, d] (constrained)
    acceptance_rates: torch.Tensor  # [num_walkers] post-burn-in acceptance
    param_names: Tuple[str, ...] = ()
    move: str = "stretch"

    @property
    def num_walkers(self) -> int:
        return self.samples.shape[0]

    def posterior_samples(self) -> WeightedSamples:
        """All walkers pooled as equal-weight posterior samples."""
        w, n, d = self.samples.shape
        pts = self.samples.reshape(w * n, d)
        return WeightedSamples(points=pts, log_weights=torch.zeros((w * n,), dtype=pts.dtype, device=pts.device))

    def per_parameter_chains(self, i: int) -> torch.Tensor:
        """[num_walkers, num_samples] draws of parameter ``i`` (each walker
        is a valid chain for ``gelman_rubin`` / ``effective_sample_size``)."""
        return self.samples[..., i]


def _run(x0, generator, log_density_batch, num_warmup, num_samples, thinning, move, knob):
    """Warmup sweeps, then ``num_samples`` recorded states each
    ``thinning`` sweeps apart.  ``knob`` is the move's one tuning number:
    the stretch scale ``a`` or the mode-jump probability.  Returns (samples
    [W, num_samples, d], acceptance [W] of the recorded sweeps)."""
    w, d = x0.shape
    state = ensemble_init(x0, log_density_batch)

    def sweep(st):
        return ensemble_sweep(ensemble_draws(generator, w, d, move=move, dtype=x0.dtype), st, log_density_batch,
                              move=move, a=knob, gamma_jump_prob=knob)

    for _ in range(num_warmup):
        state = sweep(state)
    # acceptance statistics cover the sampling phase only
    state = state._replace(accepted=torch.zeros_like(state.accepted), proposed=torch.zeros_like(state.proposed))
    xs = torch.empty((num_samples, w, d), dtype=x0.dtype, device=x0.device)
    for s in range(num_samples):
        for _ in range(thinning):
            state = sweep(state)
        xs[s] = state.x
    acc = state.accepted.to(x0.dtype) / torch.clamp(state.proposed.to(x0.dtype), min=1.0)
    return xs.transpose(0, 1), acc


def _resolve_move_knob(move, stretch_scale, gamma_jump_prob) -> float:
    """The one tuning number of the move; the other move's knob raises
    instead of being ignored."""
    if move == "stretch":
        if gamma_jump_prob is not None:
            raise ValueError('gamma_jump_prob only applies to move="de"; use stretch_scale with move="stretch"')
        return float(2.0 if stretch_scale is None else stretch_scale)
    if stretch_scale is not None:
        raise ValueError('stretch_scale only applies to move="stretch"; use gamma_jump_prob with move="de"')
    return float(0.1 if gamma_jump_prob is None else gamma_jump_prob)


def _check_walkers(num_walkers: int, d: int) -> None:
    if num_walkers < 2 * d + 2:
        raise ValueError(f"num_walkers={num_walkers} is below the 2d+2={2 * d + 2} minimum for d={d} "
                         "(stretch moves span only the walker subspace)")


def ensemble_sample(
    target: Union[InferenceProblem, Callable],
    generator: Optional[torch.Generator] = None,
    *,
    num_walkers: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    thinning: int = 1,
    move: str = "stretch",
    stretch_scale: Optional[float] = None,
    gamma_jump_prob: Optional[float] = None,
    starting_points=None,
    device=None,
) -> EnsembleResult:
    """Run an affine-invariant ensemble of ``num_walkers`` walkers.

    ``target`` is an :class:`InferenceProblem` (sampled through the box
    bijection on the problem's device; walkers default to prior draws) or a
    per-point ``log_density(theta [d]) -> scalar`` over R^d, batched by
    ``torch.func.vmap``, for which ``starting_points`` [num_walkers, d] is
    required (a tensor keeps its device; other data goes to ``device``, the
    card unless the caller asks for the CPU).  ``generator`` None is one on
    that device seeded 0.  ``move`` is ``"stretch"`` (knob
    ``stretch_scale``, default a = 2) or ``"de"`` (knob
    ``gamma_jump_prob``, default 0.1); the other move's knob raises.
    ``num_walkers`` must be even and at least 2d + 2.  Each recorded draw
    is one sweep, thinned by ``thinning``."""
    if move not in ("stretch", "de"):
        raise ValueError(f'unknown move {move!r}; use "stretch" or "de"')
    if num_walkers % 2 != 0 or num_walkers < 4:
        raise ValueError(f"num_walkers must be even and >= 4, got {num_walkers}")
    knob = _resolve_move_knob(move, stretch_scale, gamma_jump_prob)
    run = dict(num_warmup=int(num_warmup), num_samples=int(num_samples), thinning=int(thinning), move=move,
               knob=knob)

    if isinstance(target, InferenceProblem):
        _check_walkers(num_walkers, target.dim)
        generator = torch.Generator(device=target.device).manual_seed(0) if generator is None else generator
        if starting_points is None:
            from .nested_sampling import generate_starting_points

            starting_points = generate_starting_points(target, generator, num_walkers)
        x0 = torch.as_tensor(starting_points, dtype=target.dtype, device=target.device)
        if tuple(x0.shape) != (num_walkers, target.dim):
            raise ValueError(f"starting_points must be [{num_walkers}, {target.dim}]")
        bij = box_bijection(target.lower, target.upper)
        z_samples, acc = _run(bij.to_z(x0), generator, z_space_density(target, bij), **run)
        samples, names = bij.to_x(z_samples), target.param_names
    else:
        if starting_points is None:
            raise ValueError("raw-density targets need explicit starting_points [num_walkers, d]")
        x0 = as_float_on(starting_points, device)
        if x0.shape[:1] != (num_walkers,):
            raise ValueError(f"starting_points must be [{num_walkers}, d], got {tuple(x0.shape)}")
        _check_walkers(num_walkers, int(x0.shape[-1]))
        generator = torch.Generator(device=x0.device).manual_seed(0) if generator is None else generator
        samples, acc = _run(x0, generator, torch.func.vmap(target), **run)
        names = tuple(f"x{i}" for i in range(x0.shape[-1]))
    return EnsembleResult(samples=samples, acceptance_rates=acc, param_names=names, move=move)
