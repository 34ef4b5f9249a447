"""Bayesian optimization on the GP stack (port of
``bayesianinference_tpu.engines.bayesopt``).

Sequential model-based optimization of an expensive black-box function
over a box, with a GP surrogate:

- **Capacity-padded masked GP.**  The design lives in fixed
  ``[capacity, d]`` buffers with a validity mask; padded slots get
  identity rows and columns in K and zero residuals, so the Cholesky
  factors a block-diagonal ``[K_valid, I]`` and the posterior moments and
  log marginal likelihood over the valid block are exact.  The buffers
  are public API (:class:`BayesOptState`).
- **Hyperparameter adaptation.**  ARD squared-exponential hyperparameters
  (log variance, per-dimension log lengthscale, log nugget) take a few
  Adam steps on the masked logML every iteration, warm-started.
- **Batched acquisition maximization.**  The acquisition is evaluated on
  a batch of random candidates in one ``[capacity, Q]`` cross covariance,
  then the best candidate takes a few projected gradient-ascent steps.

Every covariance here is one call of the ``se_covariance`` op with the
[d] lengthscale (the JAX package's Gram-form ``_ard_se_matrix``), and
every factor of the masked K the ``cholesky`` op, so on the card both run
the hand-written kernels: about 23 factorizations of [capacity, capacity]
per suggestion at the default configuration (8 hyperparameter steps, 1
candidate batch, 12 refinement steps, 2 comparisons).

The random numbers are inputs: :func:`design_draws` makes the initial
design's jitter and column permutations, :func:`bo_draws` a suggestion's
candidates, local normals and Thompson normals (with a leading step axis
for a whole run).  The JAX package's one-program ``lax.scan`` loops (the
hyperparameter Adam steps, the refinement, ``bayes_optimize``'s run) and
its ``jax.jit`` program caches are TPU workarounds: here they are host
loops over eager steps, and ``bayes_optimize`` takes a Python callable.

Acquisitions: ``"log_ei"`` (stable log expected improvement), ``"ucb"``,
``"thompson"`` (a posterior draw at the candidates).  The surrogate models
the negated objective when minimizing, so every acquisition maximizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.device import as_float_on
from ..core.numerics import as_float, log_zero, ndtr
from ..core.optim import adam_init, adam_step
from ..ops.gp_kernels import cholesky, se_covariance

__all__ = [
    "BODraws",
    "BayesOptConfig",
    "BayesOptResult",
    "BayesOptState",
    "DesignDraws",
    "bayes_optimize",
    "bo_draws",
    "bo_init",
    "bo_observe",
    "bo_suggest",
    "design_draws",
    "log_expected_improvement",
    "masked_gp_log_marginal",
    "masked_gp_moments",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Masked (capacity-padded) GP core
# ---------------------------------------------------------------------------


def _masked_chol_alpha(x, y, mask, log_var, log_ell, log_nugget):
    """Cholesky and weights of the masked GP: the rows and columns of padded
    slots are zeroed and their diagonal set to 1, so K factors as
    block-diag([K_valid + nugget I, I]) exactly.  Returns
    (L, alpha, resid, mask_f)."""
    mask_f = mask.to(x.dtype)
    k = se_covariance(x, None, torch.exp(log_var), torch.exp(log_ell))
    k = k * (mask_f[:, None] * mask_f[None, :])
    diag_add = torch.where(mask, torch.exp(log_nugget), torch.ones_like(mask_f))
    k = k + torch.diag_embed(diag_add)
    el = cholesky(k)
    resid = torch.where(mask, y, torch.zeros_like(y))
    alpha = torch.cholesky_solve(resid[:, None], el)[:, 0]
    return el, alpha, resid, mask_f


def masked_gp_moments(x, y, mask, x_query, log_var, log_ell, log_nugget) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior predictive (mean, std) at ``x_query`` from capacity-padded
    training buffers, exact for any padding content (padded slots carry
    identity covariance and zero residual)."""
    x = as_float(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    x_query = torch.as_tensor(x_query, dtype=x.dtype, device=x.device)
    mask = torch.as_tensor(mask, device=x.device)
    el, alpha, _, mask_f = _masked_chol_alpha(x, y, mask, log_var, log_ell, log_nugget)
    k_cross = se_covariance(x, x_query, torch.exp(log_var), torch.exp(log_ell)) * mask_f[:, None]
    mean = k_cross.mT @ alpha
    v = torch.linalg.solve_triangular(el, k_cross, upper=False)
    var = torch.exp(log_var) - torch.sum(v * v, dim=0)
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def masked_gp_log_marginal(x, y, mask, log_var, log_ell, log_nugget) -> torch.Tensor:
    """Masked-GP log marginal likelihood over the valid block only: the
    padded diagonal 1s add nothing to the log determinant or the quadratic
    form, and the 2 pi constant counts ``mask.sum()`` points.  A failed
    factorization gives the log-zero sentinel."""
    x = as_float(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    mask = torch.as_tensor(mask, device=x.device)
    el, alpha, resid, mask_f = _masked_chol_alpha(x, y, mask, log_var, log_ell, log_nugget)
    n_valid = torch.sum(mask_f)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(el)))
    quad = resid @ alpha
    logml = -0.5 * (n_valid * math.log(2.0 * math.pi) + logdet + quad)
    return torch.where(torch.isfinite(logml), logml, torch.full_like(logml, log_zero(x.dtype)))


# ---------------------------------------------------------------------------
# Acquisitions
# ---------------------------------------------------------------------------


def _norm_logpdf(z):
    return -0.5 * z * z - _HALF_LOG_2PI


def log_expected_improvement(mean, std, best):
    """log EI for maximization: EI = s (z Phi(z) + phi(z)), z = (m - best)/s,
    in log space so vanishing improvements stay ordered; below z = -6 the
    asymptote h(z) ~ phi(z) / z^2."""
    mean = as_float(mean)
    std = torch.as_tensor(std, dtype=mean.dtype, device=mean.device)
    z = (mean - best) / std
    zc = torch.clamp(z, min=-6.0)
    direct = torch.log(torch.clamp(zc * ndtr(zc) + torch.exp(_norm_logpdf(zc)), min=1e-38))
    tail = _norm_logpdf(z) - 2.0 * torch.log(torch.clamp(-z, min=1.0))
    logh = torch.where(z > -6.0, direct, tail)
    return torch.log(std) + logh


def _acquisition(name: str, mean, std, best, beta, normals=None):
    if name == "log_ei":
        return log_expected_improvement(mean, std, best)
    if name == "ucb":
        return mean + beta * std
    if name == "thompson":
        return mean + std * normals
    raise ValueError(f"unknown acquisition {name!r}")


# ---------------------------------------------------------------------------
# Config, state and draws
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BayesOptConfig:
    """BO configuration.  ``num_candidates`` random box samples per step
    feed one batched acquisition evaluation; the winner takes
    ``refine_steps`` projected gradient-ascent steps.  ``hyper_steps``
    Adam steps on the masked logML run every iteration, warm-started.
    ``nugget``: the surrogate's observation-noise variance in
    standardized y units, learned when None, pinned when a float (1e-6 for
    a deterministic objective)."""

    acquisition: str = "log_ei"
    num_candidates: int = 512
    refine_steps: int = 12
    refine_lr: float = 0.05
    hyper_steps: int = 8
    hyper_lr: float = 0.08
    ucb_beta: float = 2.0
    minimize: bool = True
    nugget: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BayesOptState:
    """Ask/tell state: fixed-capacity buffers and the surrogate's
    hyperparameters.  ``y`` holds the internal sign (negated when
    minimizing); :meth:`best` gives user-facing values.  ``n``, the number
    of valid points, is a host integer."""

    x: torch.Tensor  # [capacity, d]
    y: torch.Tensor  # [capacity] internal (maximization) sign
    mask: torch.Tensor  # [capacity] bool
    n: int
    log_var: torch.Tensor
    log_ell: torch.Tensor  # [d]
    log_nugget: torch.Tensor
    lower: torch.Tensor  # [d]
    upper: torch.Tensor  # [d]

    def best(self, minimize: bool = True):
        """(x_best, y_best) among the observed points, user sign convention."""
        score = torch.where(self.mask, self.y, torch.full_like(self.y, -math.inf))
        i = torch.argmax(score).reshape(1)
        y = self.y.index_select(0, i)[0]
        return self.x.index_select(0, i)[0], (-y if minimize else y)


class DesignDraws(NamedTuple):
    """The initial design's random numbers: ``jitter`` [d, n] uniforms and
    ``order`` [d, n] a permutation of each column."""

    jitter: torch.Tensor
    order: torch.Tensor


class BODraws(NamedTuple):
    """A suggestion's random numbers (with a leading step axis for a run):
    ``candidates`` [Q, d] uniforms, ``local`` [Q // 2, d] normals around
    the incumbent, ``thompson`` [Q] and ``thompson_point`` [1] the
    Thompson draws at the candidates and at the refined point."""

    candidates: torch.Tensor
    local: torch.Tensor
    thompson: torch.Tensor
    thompson_point: torch.Tensor


def design_draws(generator: torch.Generator, n: int, d: int, dtype=torch.float32) -> DesignDraws:
    dev = generator.device
    jitter = torch.rand((d, n), generator=generator, dtype=dtype, device=dev)
    order = torch.argsort(torch.rand((d, n), generator=generator, dtype=torch.float64, device=dev), dim=-1)
    return DesignDraws(jitter, order)


def bo_draws(generator: torch.Generator, d: int, config: Optional[BayesOptConfig] = None, *, steps=None,
             dtype=torch.float32) -> BODraws:
    """One suggestion's draws, or ``steps`` of them stacked on a leading axis."""
    config = config or BayesOptConfig()
    q = config.num_candidates
    lead = () if steps is None else (steps,)
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    return BODraws(torch.rand((*lead, q, d), **kw), torch.randn((*lead, q // 2, d), **kw),
                   torch.randn((*lead, q), **kw), torch.randn((*lead, 1), **kw))


def _standardized(y, mask):
    """Masked mean and sd of the observations; the surrogate fits the
    standardized residuals."""
    mask_f = mask.to(y.dtype)
    n = torch.clamp(torch.sum(mask_f), min=1.0)
    mu = torch.sum(y * mask_f) / n
    var = torch.sum(mask_f * (y - mu) ** 2) / n
    sd = torch.sqrt(torch.clamp(var, min=1e-12))
    return mu, torch.where(n > 1.5, sd, torch.ones_like(sd))


def _hyper_adam(x01, y, mask, hypers, steps: int, lr: float, opt_nugget: bool = True):
    """``steps`` Adam steps (``core/optim.adam_step``) on the masked logML
    plus a weak log-normal hyperprior, each followed by the box clamps.
    With ``opt_nugget=False`` the nugget stays at its incoming value."""
    ln_fixed = hypers[2]
    h = dict(zip(("lv", "le", "ln"), hypers))
    state = adam_init(h)
    for _ in range(steps):
        with torch.enable_grad():
            live = {k: t.detach().requires_grad_(True) for k, t in h.items()}
            lv, le, ln = live.values()
            ln_used = ln if opt_nugget else ln_fixed
            logml = masked_gp_log_marginal(x01, y, mask, lv, le, ln_used)
            prior = (-0.5 * (lv / 2.0) ** 2 - 0.5 * torch.sum(((le + 1.0) / 2.0) ** 2)
                     - 0.5 * ((ln_used + 4.0) / 2.0) ** 2)
            g = torch.autograd.grad(-(logml + prior), list(live.values()), allow_unused=True)
        grads = {k: torch.zeros_like(h[k]) if gi is None else torch.where(torch.isfinite(gi), gi, 0.0)
                 for k, gi in zip(h, g)}
        h, state = adam_step(h, grads, state, lr)
        # keep the surrogate in a sane region (nugget floor, lengthscale box)
        h = {"lv": torch.clamp(h["lv"], -6.0, 6.0), "le": torch.clamp(h["le"], -5.0, 3.0),
             "ln": torch.clamp(h["ln"], -10.0, 2.0) if opt_nugget else ln_fixed}
    return h["lv"], h["le"], h["ln"]


def _pick(t, i):
    """Row ``i`` (a 0-d index tensor) of ``t`` without a host read."""
    return t.index_select(0, i.reshape(1))[0]


def _suggest01(x01, y, mask, hypers, draws: BODraws, config: BayesOptConfig):
    """One acquisition maximization in the unit cube: x01_next [d]."""
    lv, le, ln = hypers
    mu_y, sd_y = _standardized(y, mask)
    neg_inf = torch.full_like(y, -math.inf)
    ys = torch.where(mask, (y - mu_y) / sd_y, torch.zeros_like(y))
    best = torch.max(torch.where(mask, ys, neg_inf))
    q = config.num_candidates
    i_best = torch.argmax(torch.where(mask, ys, neg_inf))
    # half the batch explores locally around the incumbent
    local = torch.clamp(_pick(x01, i_best) + 0.1 * draws.local, 0.0, 1.0)
    cand = torch.cat([local, draws.candidates[q // 2:]], dim=0)

    def acq(points, normals):
        mean, std = masked_gp_moments(x01, ys, mask, points, lv, le, ln)
        return _acquisition(config.acquisition, mean, std, best, config.ucb_beta, normals)

    with torch.no_grad():
        x0 = _pick(cand, torch.argmax(acq(cand, draws.thompson)))

    def acq_point(p):
        return acq(p[None, :], draws.thompson_point)[0]

    # projected gradient ascent on the single best candidate
    p = x0
    for _ in range(config.refine_steps):
        with torch.enable_grad():
            live = p.detach().requires_grad_(True)
            (gi,) = torch.autograd.grad(acq_point(live), live)
        gi = torch.where(torch.isfinite(gi), gi, 0.0)
        p = torch.clamp(p + config.refine_lr * gi, 0.0, 1.0)
    with torch.no_grad():
        better = acq_point(p) >= acq_point(x0)
    return torch.where(better, p, x0)


# ---------------------------------------------------------------------------
# Ask/tell front end
# ---------------------------------------------------------------------------


def _scrambled_grid(draws: DesignDraws, n: int, dtype, device):
    """Stratified latin-hypercube-style design in the unit cube."""
    base = (torch.arange(n, dtype=dtype, device=device) + 0.5) / n
    jitter = (draws.jitter.to(device=device, dtype=dtype) - 0.5) / n
    cols = torch.gather(base + jitter, 1, draws.order.to(device))
    return torch.clamp(cols.mT, 0.0, 1.0)


def bo_init(lower, upper, capacity: int, generator: Optional[torch.Generator] = None, num_init: int = 8,
            dtype=torch.float32, *, draws: Optional[DesignDraws] = None, device=None):
    """Fresh state with ``num_init`` quasi-random initial design points.

    Returns ``(state, x_init [num_init, d])``: evaluate the objective at
    ``x_init`` and feed each pair through :func:`bo_observe`.  The design's
    random numbers come from ``draws`` (:func:`design_draws`) or from
    ``generator`` (default: seed 0 on the bounds' device).  Bounds that are
    not tensors go to ``device``, the card unless it names the CPU."""
    lower = as_float_on(lower, device).to(dtype)
    upper = torch.as_tensor(upper, device=lower.device).to(dtype)
    d = lower.shape[0]
    if num_init < 2:
        raise ValueError("num_init must be >= 2 (surrogate needs spread)")
    if capacity < num_init:
        raise ValueError("capacity must be >= num_init")
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=lower.device).manual_seed(0)
        draws = design_draws(generator, num_init, d, dtype)
    x_init = lower + (upper - lower) * _scrambled_grid(draws, num_init, dtype, lower.device)
    on = dict(dtype=dtype, device=lower.device)
    state = BayesOptState(
        x=torch.full((capacity, d), 0.5, **on), y=torch.zeros((capacity,), **on),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=lower.device), n=0,
        log_var=torch.zeros((), **on), log_ell=torch.full((d,), -1.0, **on), log_nugget=torch.full((), -4.0, **on),
        lower=lower, upper=upper)
    return state, x_init


def _appended(state: BayesOptState, x, y_internal) -> dict:
    i = state.n
    xs, ys, mask = state.x.clone(), state.y.clone(), state.mask.clone()
    xs[i] = torch.as_tensor(x, dtype=xs.dtype, device=xs.device)
    ys[i] = torch.as_tensor(y_internal, dtype=ys.dtype, device=ys.device)
    mask[i] = True
    return dict(x=xs, y=ys, mask=mask, n=i + 1)


def bo_observe(state: BayesOptState, x, y, minimize: bool = True) -> BayesOptState:
    """Append one observation (user sign convention) to the buffers."""
    y = torch.as_tensor(y, dtype=state.y.dtype, device=state.y.device)
    return dataclasses.replace(state, **_appended(state, x, -y if minimize else y))


def _step(state: BayesOptState, draws: BODraws, config: BayesOptConfig):
    """Adapted hyperparameters and the next point: (log_var, log_ell,
    log_nugget, x_next [d])."""
    span = state.upper - state.lower
    x01 = (state.x - state.lower) / span
    mu_y, sd_y = _standardized(state.y, state.mask)
    ys = torch.where(state.mask, (state.y - mu_y) / sd_y, torch.zeros_like(state.y))
    ln0 = state.log_nugget if config.nugget is None else torch.log(torch.full_like(state.log_nugget, config.nugget))
    hypers = _hyper_adam(x01, ys, state.mask, (state.log_var, state.log_ell, ln0), config.hyper_steps,
                         config.hyper_lr, opt_nugget=config.nugget is None)
    draws = BODraws(*(t.to(device=x01.device, dtype=x01.dtype) for t in draws))
    x01_next = _suggest01(x01, state.y, state.mask, hypers, draws, config)
    return (*hypers, state.lower + span * x01_next)


def bo_suggest(state: BayesOptState, draws, config: Optional[BayesOptConfig] = None):
    """Adapt the surrogate hyperparameters and propose the next point.
    ``draws`` is a :class:`BODraws` or a ``torch.Generator`` to make one
    from.  Returns ``(state, x_next [d])``."""
    config = config or BayesOptConfig()
    if isinstance(draws, torch.Generator):
        draws = bo_draws(draws, state.x.shape[1], config, dtype=state.x.dtype)
    lv, le, ln, x_next = _step(state, draws, config)
    return dataclasses.replace(state, log_var=lv, log_ell=le, log_nugget=ln), x_next


# ---------------------------------------------------------------------------
# The whole loop for a Python objective
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BayesOptResult:
    """Optimization trace; ``x_best`` and ``y_best`` follow the user's sign
    convention (``minimize=True`` by default)."""

    x_best: torch.Tensor
    y_best: torch.Tensor
    x_history: torch.Tensor  # [n_evals, d]
    y_history: torch.Tensor  # [n_evals]
    state: BayesOptState


def bayes_optimize(objective: Callable, lower, upper, generator: Optional[torch.Generator] = None,
                   num_steps: int = 24, num_init: int = 8, config: Optional[BayesOptConfig] = None,
                   dtype=torch.float32, *, draws: Optional[Tuple[DesignDraws, BODraws]] = None,
                   device=None) -> BayesOptResult:
    """Minimize (by default) ``objective([d] tensor) -> scalar`` over the box
    with GP-surrogate Bayesian optimization: ``num_init`` design points,
    then ``num_steps`` suggestions, each evaluated.  The random numbers
    come from ``draws`` = (design draws, step draws with a leading
    ``num_steps`` axis) or from ``generator`` (default: seed 0 on the
    bounds' device)."""
    config = config or BayesOptConfig()
    lower = as_float_on(lower, device).to(dtype)
    d = lower.shape[0]
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=lower.device).manual_seed(0)
        draws = (design_draws(generator, num_init, d, dtype),
                 bo_draws(generator, d, config, steps=num_steps, dtype=dtype))
    design, steps = draws
    state, x_init = bo_init(lower, upper, num_init + num_steps, num_init=num_init, dtype=dtype, draws=design)
    sign = -1.0 if config.minimize else 1.0
    xs, ys = [], []

    def record(st, x):
        y = torch.as_tensor(objective(x), device=st.y.device).to(st.y.dtype)
        xs.append(x)
        ys.append(y)
        return dataclasses.replace(st, **_appended(st, x, sign * y))

    for x in x_init:
        state = record(state, x)
    for i in range(num_steps):
        lv, le, ln, x_next = _step(state, BODraws(*(t[i] for t in steps)), config)
        state = record(dataclasses.replace(state, log_var=lv, log_ell=le, log_nugget=ln), x_next)
    x_hist, y_hist = torch.stack(xs), torch.stack(ys)
    i = (torch.argmin(y_hist) if config.minimize else torch.argmax(y_hist)).reshape(1)
    return BayesOptResult(x_best=x_hist.index_select(0, i)[0], y_best=y_hist.index_select(0, i)[0],
                          x_history=x_hist, y_history=y_hist, state=state)
