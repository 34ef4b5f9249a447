"""Gradient-based posterior sampling: the HMC engine (port of
``bayesianinference_tpu.engines.hmc``).

Box-bounded problems are sampled in unconstrained coordinates through
:func:`..core.transforms.box_bijection`, its log-Jacobian added to the
density, so trajectories never meet the support boundary.  Constraints
beyond the box still act by rejection (the sentinel).

The JAX package jit-compiles one program per problem structure and caches
density programs in an ``lru_cache``; both are XLA workarounds and are not
ported: the chains run as host loops over batched tensor calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from ..core.containers import WeightedSamples
from ..core.device import as_float_on
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.hmc import warmup_and_sample

__all__ = ["HMCResult", "hmc_sample"]


def _run_kernel(generator, z0, z_density, *, num_warmup, num_samples, num_leapfrog, thinning, target_accept,
                initial_step_size, dense_mass, max_leapfrog, draws=None):
    """Fixed-length or ChEES trajectories, with one return shape (samples,
    states, step size, inverse mass, trajectory length); the fixed kernel's
    length is ``num_leapfrog * step_size``.  ``draws`` (``HMCDraws``, or
    ``ChEESDraws`` for ``"auto"``, with a leading trajectory axis) replace
    the generator's numbers."""
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, thinning=thinning, target_accept=target_accept,
              initial_step_size=initial_step_size, dense_mass=dense_mass, draws=draws)
    if num_leapfrog == "auto":
        from ..ops.chees import chees_warmup_and_sample

        return chees_warmup_and_sample(generator, z0, z_density, max_leapfrog=max_leapfrog, **kw)
    z_samples, states, step_size, inv_mass = warmup_and_sample(generator, z0, z_density, num_leapfrog=num_leapfrog,
                                                               **kw)
    return z_samples, states, step_size, inv_mass, num_leapfrog * step_size


def z_space_density(problem: InferenceProblem, bij) -> Callable:
    """The problem's log posterior density in z-space: at x = to_x(z), plus
    the log-Jacobian, batched over [..., d]."""

    def z_density(z):
        return problem.log_posterior_density(bij.to_x(z)) + bij.log_jacobian(z)

    return z_density


def bijected_warmup_and_sample(x0, generator, problem: InferenceProblem, *, num_warmup, num_samples, num_leapfrog,
                               thinning, target_accept, initial_step_size, dense_mass=False, max_leapfrog=256,
                               draws=None):
    """Warmup and sampling in z-space through the box bijection, from the
    constrained starting points ``x0`` [C, d]; ``draws`` as for
    :func:`_run_kernel`.  Returns (constrained samples, final states, step
    size, inverse mass in z-space, trajectory length)."""
    bij = box_bijection(problem.lower, problem.upper)
    z_samples, states, step_size, inv_mass, traj_len = _run_kernel(
        generator, bij.to_z(x0), z_space_density(problem, bij), num_warmup=num_warmup, num_samples=num_samples,
        num_leapfrog=num_leapfrog, thinning=thinning, target_accept=target_accept,
        initial_step_size=initial_step_size, dense_mass=dense_mass, max_leapfrog=max_leapfrog, draws=draws)
    return bij.to_x(z_samples), states, step_size, inv_mass, traj_len


def states_to_hmc_result(samples, states, step_size, inv_mass, param_names, trajectory_length=None) -> "HMCResult":
    """The public result from the kernel's outputs."""
    dtype = samples.dtype
    acc = states.accepted.to(dtype) / torch.clamp(states.proposed.to(dtype), min=1.0)
    return HMCResult(samples=samples, acceptance_rates=acc, divergences=states.divergences, step_size=step_size,
                     inv_mass_diag=inv_mass, param_names=param_names, trajectory_length=trajectory_length)


@dataclasses.dataclass(frozen=True)
class HMCResult:
    """Output of :func:`hmc_sample`."""

    samples: torch.Tensor  # [chains, num_samples, d] (constrained space)
    acceptance_rates: torch.Tensor  # [chains] sampling-phase acceptance
    divergences: torch.Tensor  # [chains] sampling-phase divergent trajectories
    step_size: torch.Tensor  # adapted leapfrog step size
    inv_mass_diag: torch.Tensor  # [d] adapted inverse mass (z-space); [d, d] with dense_mass
    param_names: Tuple[str, ...] = ()
    # realized trajectory time eps * L: learned for num_leapfrog="auto", else the fixed product (z-space units)
    trajectory_length: Optional[torch.Tensor] = None

    @property
    def num_chains(self) -> int:
        return self.samples.shape[0]

    def posterior_samples(self) -> WeightedSamples:
        """All chains pooled as equal-weight posterior samples."""
        c, n, d = self.samples.shape
        pts = self.samples.reshape(c * n, d)
        return WeightedSamples(points=pts, log_weights=torch.zeros((c * n,), dtype=pts.dtype, device=pts.device))

    def per_parameter_chains(self, i: int) -> torch.Tensor:
        """[chains, num_samples] draws of parameter ``i``: the shape of
        ``results.gelman_rubin`` and ``results.effective_sample_size``."""
        return self.samples[..., i]


def hmc_sample(
    target: Union[InferenceProblem, Callable],
    generator: Optional[torch.Generator] = None,
    *,
    num_chains: int = 4,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog: Union[int, str] = 32,
    thinning: int = 1,
    target_accept: float = 0.8,
    starting_points=None,
    initial_step_size: float = 0.1,
    dense_mass: bool = False,
    max_leapfrog: int = 256,
    device=None,
    draws=None,
) -> HMCResult:
    """Run ``num_chains`` HMC chains, batched, with a windowed warmup.

    ``target`` is an :class:`InferenceProblem` (sampled through the box
    bijection; starting points default to prior draws; it runs on the
    problem's device) or a per-point ``log_density(theta [d]) -> scalar``
    over R^d, batched by ``torch.func.vmap``, for which ``starting_points``
    [num_chains, d] is required (a tensor keeps its device; other data goes
    to ``device``, the card unless the caller asks for the CPU).
    ``generator`` None is a generator on that device seeded 0.

    ``num_leapfrog`` is the fixed trajectory length in steps, or
    ``"auto"`` to learn it by ChEES (capped at ``max_leapfrog`` steps).
    ``dense_mass=True`` adapts the full posterior covariance as the inverse
    mass.  ``starting_points="pathfinder"`` starts the chains at draws of a
    Pathfinder fit (``min(max(num_chains, 4), 8)`` paths, 128 draws per
    path) made from ``generator`` first; ``"flow"`` at draws of a flow-VI
    fit (1000 steps, 256 final draws), as the JAX package does.  ``draws``
    (``HMCDraws``, or ``ChEESDraws`` for ``"auto"``, one row per
    trajectory) replace the generator's numbers of the chains."""
    if num_leapfrog != "auto" and (not isinstance(num_leapfrog, int) or num_leapfrog < 1):
        raise ValueError(f'num_leapfrog must be a positive int or "auto", got {num_leapfrog!r}')
    if isinstance(starting_points, str):
        if starting_points not in ("pathfinder", "flow"):
            raise ValueError(f'unknown starting_points {starting_points!r}; expected an array, "pathfinder", or "flow"')
        if not isinstance(target, InferenceProblem):
            raise ValueError(f'starting_points="{starting_points}" needs an InferenceProblem target')
        generator = torch.Generator(device=target.device).manual_seed(0) if generator is None else generator
        if starting_points == "pathfinder":
            from .pathfinder import pathfinder_fit

            pf = pathfinder_fit(target, generator, num_paths=min(max(num_chains, 4), 8), num_draws_per_path=128)
            starting_points = pf.posterior_samples(generator, num_chains).points
        else:
            from .flow_vi import flow_vi_fit

            fl = flow_vi_fit(target, generator, num_steps=1000, final_evidence_samples=256)
            starting_points = fl.sample(generator, num_chains)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog, thinning=thinning,
              target_accept=float(target_accept), initial_step_size=float(initial_step_size),
              dense_mass=bool(dense_mass), max_leapfrog=int(max_leapfrog), draws=draws)

    if isinstance(target, InferenceProblem):
        dev = target.device
        generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
        if starting_points is None:
            from .nested_sampling import generate_starting_points

            starting_points = generate_starting_points(target, generator, num_chains)
        x0 = torch.as_tensor(starting_points, dtype=target.dtype, device=dev)
        if tuple(x0.shape) != (num_chains, target.dim):
            raise ValueError(f"starting_points must be [{num_chains}, {target.dim}]")
        out = bijected_warmup_and_sample(x0, generator, target, **kw)
        names = target.param_names
    else:
        if starting_points is None:
            raise ValueError("raw-density targets need explicit starting_points [num_chains, d]")
        x0 = as_float_on(starting_points, device)
        if x0.dim() != 2 or x0.shape[0] != num_chains:
            raise ValueError(f"starting_points must be [{num_chains}, d], got shape {tuple(x0.shape)}")
        generator = torch.Generator(device=x0.device).manual_seed(0) if generator is None else generator
        out = _run_kernel(generator, x0, torch.func.vmap(target), **kw)
        names = tuple(f"x{i}" for i in range(x0.shape[-1]))
    samples, states, step_size, inv_mass, traj_len = out
    return states_to_hmc_result(samples, states, step_size, inv_mass, names, traj_len)
