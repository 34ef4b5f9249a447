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
import itertools
from typing import Callable, Optional, Tuple, Union

import torch

from ..core.containers import WeightedSamples
from ..core.device import as_float_on
from ..core.shards import ShardAxis
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.ensemble import EnsembleState, ensemble_draws, shard_sweep
from .hmc import problem_chains, z_space_density

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


def _run(x0, generator, log_density_batch, num_warmup, num_samples, thinning, move, knob, draws=None, shards=None):
    """Warmup sweeps, then ``num_samples`` recorded states each
    ``thinning`` sweeps apart.  ``knob`` is the move's one tuning number:
    the stretch scale ``a`` or the mode-jump probability.  ``draws`` (the
    two halves' draws with a leading sweep axis, in run order) replace the
    generator's numbers.  With ``shards`` (a
    :class:`..core.shards.ShardAxis`; ``log_density_batch`` then one
    density per shard) each half's rows are split over the shards, each
    shard moving its part against the gathered complementary half
    (:func:`..ops.ensemble.shard_sweep`).  Returns (samples [W,
    num_samples, d], acceptance [W] of the recorded sweeps) on ``x0``'s
    device."""
    w, d = x0.shape
    h = w // 2
    if shards is None:
        shards, log_density_batch = ShardAxis.one(x0.device), [log_density_batch]
    halves = ([], [])
    for xa, xb, fn in zip(shards.split(x0[:h]), shards.split(x0[h:]), log_density_batch):
        # one density call of the shard's walkers, as the one-batch engine makes one of all of them
        lp = fn(torch.cat([xa, xb]))
        zero = torch.zeros((xa.shape[0],), dtype=torch.int64, device=xa.device)
        halves[0].append(EnsembleState(x=xa, log_density=lp[:xa.shape[0]], accepted=zero, proposed=zero))
        halves[1].append(EnsembleState(x=xb, log_density=lp[xa.shape[0]:], accepted=zero, proposed=zero))
    sweeps = itertools.count()

    def sweep(halves):
        if draws is None:
            whole = ensemble_draws(generator, w, d, move=move, dtype=x0.dtype)
        else:
            s = next(sweeps)
            whole = tuple(type(half)(*(a[s] for a in half)) for half in draws)
        parts = tuple([type(half)(*fields) for fields in zip(*(shards.split(a) for a in half))] for half in whole)
        return shard_sweep(shards, parts, halves, log_density_batch, move=move, a=knob, gamma_jump_prob=knob)

    for _ in range(num_warmup):
        halves = sweep(halves)
    # acceptance statistics cover the sampling phase only
    halves = tuple([st._replace(accepted=torch.zeros_like(st.accepted), proposed=torch.zeros_like(st.proposed))
                    for st in part] for part in halves)
    bufs = tuple([torch.empty((num_samples,) + tuple(st.x.shape), dtype=x0.dtype, device=st.x.device)
                  for st in part] for part in halves)
    for s in range(num_samples):
        for _ in range(thinning):
            halves = sweep(halves)
        for part, buf in zip(halves, bufs):
            for st, b in zip(part, buf):
                b[s] = st.x
    xs = torch.cat([shards.gather([b.transpose(0, 1) for b in buf]) for buf in bufs])
    acc = torch.cat([shards.gather([st.accepted.to(x0.dtype) / torch.clamp(st.proposed.to(x0.dtype), min=1.0)
                                    for st in part]) for part in halves])
    return xs, acc


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


def run_options(*, num_walkers, num_warmup, num_samples, thinning, move, stretch_scale, gamma_jump_prob,
                draws) -> dict:
    """The run's options as :func:`_run` takes them, once the move, its
    knob and the walker count are checked."""
    if move not in ("stretch", "de"):
        raise ValueError(f'unknown move {move!r}; use "stretch" or "de"')
    if num_walkers % 2 != 0 or num_walkers < 4:
        raise ValueError(f"num_walkers must be even and >= 4, got {num_walkers}")
    return dict(num_warmup=int(num_warmup), num_samples=int(num_samples), thinning=int(thinning), move=move,
                knob=_resolve_move_knob(move, stretch_scale, gamma_jump_prob), draws=draws)


def sample_problem(problem: InferenceProblem, generator, num_walkers: int, starting_points, options: dict,
                   shards=None, shard_problems=None) -> "EnsembleResult":
    """:func:`ensemble_sample` of a problem, in the box bijection's z-space,
    with :func:`run_options`' ``options``.  With ``shards`` (a
    :class:`..core.shards.ShardAxis` whose home is the problem's device;
    None: one shard, the problem itself) each half's rows are split over
    the shards, each evaluated on its copy of the problem in
    ``shard_problems``."""
    if shards is None:
        shards, shard_problems = ShardAxis.one(problem.device), [problem]
    _check_walkers(num_walkers, problem.dim)
    generator, x0 = problem_chains(problem, generator, num_walkers, starting_points)
    bij = box_bijection(problem.lower, problem.upper)
    densities = [z_space_density(p, box_bijection(p.lower, p.upper)) for p in shard_problems]
    z_samples, acc = _run(bij.to_z(x0), generator, densities, shards=shards, **options)
    return EnsembleResult(samples=bij.to_x(z_samples), acceptance_rates=acc, param_names=problem.param_names,
                          move=options["move"])


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
    draws=None,
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
    is one sweep, thinned by ``thinning``.  ``draws`` (the two halves'
    ``StretchDraws`` or ``DEDraws`` with a leading sweep axis, warmup
    first) replace the generator's numbers of the sweeps."""
    run = run_options(num_walkers=num_walkers, num_warmup=num_warmup, num_samples=num_samples, thinning=thinning,
                      move=move, stretch_scale=stretch_scale, gamma_jump_prob=gamma_jump_prob, draws=draws)
    if isinstance(target, InferenceProblem):
        return sample_problem(target, generator, num_walkers, starting_points, run)
    if starting_points is None:
        raise ValueError("raw-density targets need explicit starting_points [num_walkers, d]")
    x0 = as_float_on(starting_points, device)
    if x0.shape[:1] != (num_walkers,):
        raise ValueError(f"starting_points must be [{num_walkers}, d], got {tuple(x0.shape)}")
    _check_walkers(num_walkers, int(x0.shape[-1]))
    generator = torch.Generator(device=x0.device).manual_seed(0) if generator is None else generator
    samples, acc = _run(x0, generator, torch.func.vmap(target), **run)
    return EnsembleResult(samples=samples, acceptance_rates=acc, param_names=tuple(f"x{i}" for i in
                                                                                   range(x0.shape[-1])), move=move)
