"""Automatic-differentiation variational inference (port of
``bayesianinference_tpu.engines.vi``).

ADVI (Kucukelbir et al. 2017) fits a Gaussian in the unconstrained space
of the box bijection (:func:`..core.transforms.box_bijection`) by
stochastic reparameterization gradients.  Each step is one value and
gradient of the batched log posterior at ``num_elbo_samples`` draws, so on
a GP problem both hand kernels and both reverse rules run at that batch.
The step size follows optax's cosine-decayed Adam (:mod:`..core.optim`).
The ELBO ``E_q[logpost(x(z)) + log|J(z)|] + H(q)`` lower-bounds the log
evidence; the entropy is closed-form.

The random numbers are inputs: :func:`vi_draws` makes the step normals
``[num_steps, num_elbo_samples, d]`` and the final bound's
``[final_elbo_samples, d]`` (:class:`VIDraws`); a fit takes them as
``draws=`` (tests replay the JAX key tree that way) or makes them from
``generator``.

Not ported, as XLA workarounds: the ``jax.jit`` program cache keyed on the
static arguments (``_advi_program``) and the one-program ``lax.scan`` over
steps (a host loop over eager steps here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import is_log_zero, log_zero
from ..core.optim import adam_init, adam_step, cosine_decay_schedule
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.chmc import _safe_grad
from .hmc import z_space_density

__all__ = ["VIDraws", "VIResult", "advi_fit", "vi_draws"]

# points per batched density call when a fit evaluates many draws at once
# (the final bound, Pathfinder's ELBO block, bridge sampling's sweeps): at
# the GP slice's n = 512 in float64, K and its factor take 4 MiB a point
EVAL_CHUNK = 1024


def z_log_target(problem: InferenceProblem, bij) -> Callable:
    """HMC's z-space density (the log posterior at x(z) plus the
    log-Jacobian, batched over [..., d]) with every log-zero value (an extra
    constraint, NaN) replaced by the sentinel itself."""
    density = z_space_density(problem, bij)
    lz = log_zero(problem.dtype)

    def log_target(z):
        lp = density(z)
        return torch.where(is_log_zero(lp), torch.full_like(lp, lz), lp)

    return log_target


def in_chunks(fn: Callable, z: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``z`` [N, d], ``EVAL_CHUNK`` rows per call."""
    chunk = EVAL_CHUNK
    if z.shape[0] <= chunk:
        return fn(z)
    return torch.cat([fn(z[i:i + chunk]) for i in range(0, z.shape[0], chunk)])


class VIDraws(NamedTuple):
    """The standard normals of a fit: ``steps`` [num_steps,
    num_elbo_samples, d], one batch per Adam step, and ``final``
    [final_elbo_samples, d] for the final ELBO estimate."""

    steps: torch.Tensor
    final: torch.Tensor


def vi_draws(generator: torch.Generator, num_steps: int, num_elbo_samples: int, final_elbo_samples: int, dim: int,
             dtype=torch.float64) -> VIDraws:
    """A fit's draws from ``generator`` (on its device)."""
    dev = generator.device
    steps = torch.randn((num_steps, num_elbo_samples, dim), generator=generator, dtype=dtype, device=dev)
    final = torch.randn((final_elbo_samples, dim), generator=generator, dtype=dtype, device=dev)
    return VIDraws(steps, final)


@dataclasses.dataclass(frozen=True)
class VIResult:
    """A fitted variational posterior (Gaussian in unconstrained space)."""

    loc: torch.Tensor  # [d] variational mean (z-space)
    scale_tril: torch.Tensor  # [d, d] Cholesky factor (z-space)
    elbo: torch.Tensor  # final ELBO estimate (lower-bounds log evidence)
    elbo_history: torch.Tensor  # [num_steps] per-step minibatch ELBO
    lower: torch.Tensor  # [d] problem box (for the bijection)
    upper: torch.Tensor  # [d]
    param_names: Tuple[str, ...] = ()
    family: str = "meanfield"

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, generator: Optional[torch.Generator], num_samples: int, *,
               normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[num_samples, d] draws from the fitted posterior, constrained
        space; ``normals`` [num_samples, d] replaces the generator's."""
        bij = box_bijection(self.lower, self.upper)
        if normals is None:
            normals = torch.randn((num_samples, self.dim), generator=generator, dtype=self.loc.dtype,
                                  device=self.loc.device)
        z = self.loc + normals.to(self.loc) @ self.scale_tril.T
        return bij.to_x(z)

    def posterior_samples(self, generator: Optional[torch.Generator], num_samples: int = 4000, *,
                          normals: Optional[torch.Tensor] = None) -> WeightedSamples:
        pts = self.sample(generator, num_samples, normals=normals)
        return WeightedSamples(points=pts, log_weights=torch.zeros((pts.shape[0],), dtype=pts.dtype,
                                                                  device=pts.device))

    def log_prob(self, x) -> torch.Tensor:
        """Fitted-posterior log density at constrained-space ``x`` [..., d]
        (Gaussian in z minus the bijection volume)."""
        bij = box_bijection(self.lower, self.upper)
        z = bij.to_z(x)
        diff = z - self.loc
        d = self.dim
        # batch axes ride as right-hand-side columns of one triangular solve
        sol = torch.linalg.solve_triangular(self.scale_tril, diff.reshape(-1, d).T, upper=False)
        maha = torch.sum(sol * sol, dim=0).reshape(diff.shape[:-1])
        logdet = torch.sum(torch.log(torch.diagonal(self.scale_tril)))
        lp_z = -0.5 * maha - 0.5 * d * math.log(2.0 * math.pi) - logdet
        return lp_z - bij.log_jacobian(z)


def _family(family: str, d: int):
    """(draw(params, eps [S, d]) -> z [S, d], entropy(params), scale_tril(params))."""
    half_log_2pi_e = 0.5 * (1.0 + math.log(2.0 * math.pi))
    if family == "meanfield":
        def draw(p, eps):
            return p["loc"] + torch.exp(p["log_scale"]) * eps

        def entropy(p):
            return torch.sum(p["log_scale"]) + d * half_log_2pi_e

        def tril(p):
            return torch.diag(torch.exp(p["log_scale"]))
    else:
        def tril(p):
            return torch.tril(p["off"], diagonal=-1) + torch.diag(torch.exp(p["log_diag"]))

        def draw(p, eps):
            return p["loc"] + eps @ tril(p).T

        def entropy(p):
            return torch.sum(p["log_diag"]) + d * half_log_2pi_e

    return draw, entropy, tril


def advi_fit(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    family: str = "meanfield",
    num_steps: int = 3000,
    num_elbo_samples: int = 32,
    learning_rate: float = 0.02,
    final_elbo_samples: int = 4096,
    initial_point=None,
    draws: Optional[VIDraws] = None,
) -> VIResult:
    """Fit a Gaussian variational posterior by ADVI.

    ``family``: ``"meanfield"`` (diagonal covariance) or ``"fullrank"``
    (dense Cholesky).  The returned ``elbo`` lower-bounds the log evidence.
    ``initial_point`` (constrained space) seeds the variational mean;
    default is the bijection's image of zero (the box centre).  The fit
    runs on the problem's device; ``generator`` None is one there seeded 0,
    and ``draws`` (:func:`vi_draws`) replaces its numbers."""
    if family not in ("meanfield", "fullrank"):
        raise ValueError(f"unknown family {family!r}")
    dev, dtype, d = problem.device, problem.dtype, problem.dim
    bij = box_bijection(problem.lower, problem.upper)
    if initial_point is not None:
        z0 = bij.to_z(torch.as_tensor(initial_point, dtype=dtype, device=dev))
    else:
        z0 = torch.zeros((d,), dtype=dtype, device=dev)
    if draws is None:
        generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
        draws = vi_draws(generator, num_steps, num_elbo_samples, final_elbo_samples, d, dtype)
    if tuple(draws.steps.shape) != (num_steps, num_elbo_samples, d) or tuple(draws.final.shape) != (
            final_elbo_samples, d):
        raise ValueError(f"draws must be [{num_steps}, {num_elbo_samples}, {d}] and [{final_elbo_samples}, {d}]")
    log_target = z_log_target(problem, bij)
    draw, entropy, tril = _family(family, d)

    def neg_elbo(params, eps):
        return -(torch.mean(in_chunks(log_target, draw(params, eps))) + entropy(params))

    params = {"loc": z0, ("log_scale" if family == "meanfield" else "log_diag"): torch.full((d,), -1.0, dtype=dtype,
                                                                                          device=dev)}
    if family == "fullrank":
        params["off"] = torch.zeros((d, d), dtype=dtype, device=dev)  # strictly-lower part used
    # cosine-decayed Adam: the Monte-Carlo gradient noise otherwise leaves
    # the final iterate wandering about 0.2 posterior sd around the optimum
    schedule = cosine_decay_schedule(learning_rate, num_steps, alpha=0.01)
    state = adam_init(params)
    history = []
    for t in range(num_steps):
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = neg_elbo(p, draws.steps[t])
            grads = torch.autograd.grad(loss, list(p.values()))
        # a draw far in the tail can touch guarded regions whose gradients
        # are not finite: those entries skip the update
        grads = {k: _safe_grad(g) for k, g in zip(p, grads)}
        params, state = adam_step(params, grads, state, schedule(state.count))
        history.append(-loss.detach())
    with torch.no_grad():
        elbo = -neg_elbo(params, draws.final)
    return VIResult(
        loc=params["loc"], scale_tril=tril(params), elbo=elbo,
        elbo_history=torch.stack(history) if history else torch.zeros((0,), dtype=dtype, device=dev),
        lower=problem.lower, upper=problem.upper, param_names=problem.param_names, family=family,
    )
