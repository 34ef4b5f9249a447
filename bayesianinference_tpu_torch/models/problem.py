"""Inference-problem definition (port of ``bayesianinference_tpu.models.problem``).

User callables stay per point, as in the JAX package: ``log_likelihood(theta)``
or ``log_likelihood(theta, data)`` and ``log_prior(theta)`` map one
parameter vector [d] to a scalar.  The problem batches them with
``torch.func.vmap``, so every density method here takes ``theta`` of shape
[..., d] and returns [...].

The problem's device and dtype are those of its bounds, which come from
the data (when given) or from the ``device``/``dtype`` arguments of
:func:`define_inference_problem`.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.device import resolve_device
from ..core.numerics import guard_log_density, log_zero
from ..dists.base import Distribution
from ..dists.combinators import ImproperUniform, Product, Truncated
from ..dists.scalar import Cauchy, LogUniform, Uniform

__all__ = [
    "InferenceProblem",
    "ParamSpec",
    "ignorance_prior",
    "define_inference_problem",
    "iid_likelihood",
    "regression_likelihood",
    "validate_problem",
    "random_domain_points",
]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: name and box bounds."""

    name: str
    low: float = -math.inf
    high: float = math.inf


def _tree_map(fn, data):
    if isinstance(data, (tuple, list)):
        return type(data)(_tree_map(fn, d) for d in data)
    if isinstance(data, dict):
        return {k: _tree_map(fn, v) for k, v in data.items()}
    return fn(data)


def _first_tensor(data):
    if isinstance(data, torch.Tensor):
        return data
    items = data.values() if isinstance(data, dict) else data if isinstance(data, (tuple, list)) else ()
    for d in items:
        t = _first_tensor(d)
        if t is not None:
            return t
    return None


@dataclasses.dataclass(frozen=True)
class InferenceProblem:
    """A problem: box bounds, per-point densities and (optionally) data.

    Outside the box, or where ``constraint`` is false, the guarded
    densities return the finite log-zero sentinel."""

    lower: torch.Tensor  # [d]
    upper: torch.Tensor  # [d]
    log_likelihood: Callable
    log_prior: Callable
    param_names: Tuple[str, ...] = ()
    prior_distribution: Optional[Distribution] = None
    constraint: Optional[Callable] = None  # theta [d] -> bool
    metadata: Optional[dict] = None
    # observed data; when present the likelihood is called as f(theta, data)
    data: Optional[object] = None
    # the likelihood takes the whole batch [B, d] -> [B] itself (set by the
    # engines whose likelihood runs a host loop, which torch.func.vmap cannot)
    batched_likelihood: bool = False

    @property
    def dim(self) -> int:
        return len(self.param_names)

    @property
    def device(self) -> torch.device:
        return self.lower.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lower.dtype

    def with_data(self, data) -> "InferenceProblem":
        """Same problem, new observations (same container structure)."""
        if self.data is None:
            raise ValueError(
                "this problem's likelihood closes over its data; build it "
                "with define_inference_problem(likelihood=..., data=...) "
                "or a (theta, data) log_likelihood to enable with_data"
            )
        old = _first_tensor(self.data)
        conv = lambda t: torch.as_tensor(t, dtype=old.dtype, device=old.device)  # noqa: E731
        return dataclasses.replace(self, data=_tree_map(conv, data))

    def with_metadata(self, **kw) -> "InferenceProblem":
        """A copy whose ``metadata`` is this one's updated with ``kw``; this
        problem is left unchanged."""
        md = dict(self.metadata or {})
        md.update(kw)
        return dataclasses.replace(self, metadata=md)

    def _batched(self, fn: Callable, theta, *extra) -> torch.Tensor:
        theta = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        flat = theta.reshape(-1, theta.shape[-1])
        in_dims = (0,) + (None,) * len(extra)
        out = torch.func.vmap(fn, in_dims=in_dims)(flat, *extra)
        return out.reshape(theta.shape[:-1])

    def raw_log_likelihood(self, theta) -> torch.Tensor:
        """The unguarded likelihood, data-aware, batched over [..., d]."""
        if self.batched_likelihood:
            theta = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
            return self.log_likelihood(theta.reshape(-1, theta.shape[-1])).reshape(theta.shape[:-1])
        if self.data is not None:
            return self._batched(self.log_likelihood, theta, self.data)
        return self._batched(self.log_likelihood, theta)

    def in_support(self, theta) -> torch.Tensor:
        theta = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        ok = ((theta >= self.lower) & (theta <= self.upper)).all(dim=-1)
        if self.constraint is not None:
            ok = ok & self._batched(self.constraint, theta).to(torch.bool)
        return ok

    def _guard(self, theta, raw) -> torch.Tensor:
        lz = torch.full_like(raw, log_zero(raw.dtype))
        return torch.where(self.in_support(theta), guard_log_density(raw), lz)

    def guarded_log_likelihood(self, theta) -> torch.Tensor:
        return self._guard(theta, self.raw_log_likelihood(theta))

    def guarded_log_prior(self, theta) -> torch.Tensor:
        return self._guard(theta, self._batched(self.log_prior, theta))

    def log_posterior_density(self, theta) -> torch.Tensor:
        """log prior + log likelihood, guarded."""
        raw = self.raw_log_likelihood(theta) + self._batched(self.log_prior, theta)
        return self._guard(theta, raw)

    def constrained_log_prior(self, theta, threshold) -> torch.Tensor:
        """The guarded log prior where the guarded likelihood exceeds
        ``threshold``, log-zero elsewhere: the density that nested
        sampling's replacement chains sample."""
        ll = guard_log_density(self.raw_log_likelihood(theta))
        lp = guard_log_density(self._batched(self.log_prior, theta))
        return torch.where(self.in_support(theta) & (ll > threshold), lp, torch.full_like(lp, log_zero(lp.dtype)))

    def gradient_sanity(self) -> bool:
        """Whether ``grad logL`` is usable: the gate of the nested-sampling
        ``"auto"`` policy before it picks constrained HMC at high d.

        The gradient of the guarded likelihood is taken at two off-centre
        probes (0.618 and 0.382 of the box; +0.7 and -0.7 on unbounded
        axes), since the centre of the box is the mode of a centred
        likelihood and a healthy gradient is zero there.  It must be finite
        at both and nonzero somewhere; a likelihood built from lookups or
        rounding (zero or NaN gradient) fails, and so does any exception.
        The answer is memoized on the problem object."""
        cached = getattr(self, "_gradient_sanity_cache", None)
        if cached is not None:
            return cached
        try:
            lo, hi = self.lower, self.upper
            both = torch.isfinite(lo) & torch.isfinite(hi)
            ok_any, ok_fin = False, True
            for frac, fallback in ((0.618, 0.7), (0.382, -0.7)):
                probe = torch.where(both, lo + frac * (hi - lo),
                                    torch.clamp(torch.full_like(lo, fallback), min=lo, max=hi))
                with torch.enable_grad():
                    probe = probe.detach().requires_grad_(True)
                    (g,) = torch.autograd.grad(self.guarded_log_likelihood(probe), probe)
                ok_fin = ok_fin and bool(torch.isfinite(g).all())
                ok_any = ok_any or bool((g != 0).any())
            ok = ok_fin and ok_any
        except Exception:  # the probe is advisory: whatever fails means "no usable gradient"
            ok = False
        object.__setattr__(self, "_gradient_sanity_cache", ok)
        return ok


def _first_coordinate_log_prob(prior: Distribution, theta) -> torch.Tensor:
    """A scalar prior's log density of a one-parameter problem's theta [1]."""
    return prior.log_prob(theta[..., 0])


def _as_param_specs(parameters) -> Tuple[ParamSpec, ...]:
    out = []
    for p in parameters:
        if isinstance(p, ParamSpec):
            out.append(p)
        elif isinstance(p, str):
            out.append(ParamSpec(p))
        elif isinstance(p, (tuple, list)):
            name, lo, hi = p
            out.append(ParamSpec(str(name), float(lo), float(hi)))
        else:
            raise ValueError(f"bad parameter spec: {p!r}")
    return tuple(out)


def ignorance_prior(
    specs: Sequence, parameters: Sequence, *, dtype=None, device=None
) -> Product:
    """Product prior from per-parameter ignorance specs: ``"location"``
    (uniform over the box), ``"scale"`` (normalized 1/x over the box,
    0 < low < high), or a :class:`Distribution` (truncated to the box).
    Bounds become tensors of ``dtype`` on ``device``."""
    params = _as_param_specs(parameters)
    if len(specs) != len(params):
        raise ValueError("one ignorance spec per parameter required")
    dtype = dtype or torch.get_default_dtype()
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    comps = []
    for spec, p in zip(specs, params):
        finite = math.isfinite(p.low) and math.isfinite(p.high)
        if isinstance(spec, str) and spec.lower() in ("location", "locationparameter"):
            if not finite:
                raise ValueError(f"location parameter {p.name} needs finite bounds")
            comps.append(Uniform(low=t(p.low), high=t(p.high)))
        elif isinstance(spec, str) and spec.lower() in ("scale", "scaleparameter"):
            if not (p.low > 0 and math.isfinite(p.high)):
                raise ValueError(f"scale parameter {p.name} needs bounds 0 < low < high")
            comps.append(LogUniform(low=t(p.low), high=t(p.high)))
        elif isinstance(spec, Distribution):
            if math.isfinite(p.low) or math.isfinite(p.high):
                comps.append(Truncated(spec, low=t(p.low), high=t(p.high)))
            else:
                comps.append(spec)
        else:
            raise ValueError(f"bad ignorance prior spec: {spec!r}")
    return Product(tuple(comps))


@functools.lru_cache(maxsize=256)
def _iid_loglike(dist_builder: Callable) -> Callable:
    """Data-aware i.i.d. log-likelihood, identity-stable per builder."""

    def log_likelihood(theta, data):
        return torch.sum(dist_builder(theta).log_prob(data))

    return log_likelihood


@functools.lru_cache(maxsize=256)
def _regression_loglike(dist_builder: Callable) -> Callable:
    """Data-aware regression log-likelihood over ``data = (x, y)``."""

    def log_likelihood(theta, data):
        x, y = data
        return torch.sum(dist_builder(theta, x).log_prob(y))

    return log_likelihood


def _data_tensor(data, device) -> torch.Tensor:
    """Observations as a tensor: a tensor keeps its device unless ``device``
    names another; anything else goes to ``device``, the card by default."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(torch.device(device))
    return torch.as_tensor(data, device=resolve_device(device))


def iid_likelihood(dist_builder: Callable, data, *, device=None) -> Callable:
    """Per-point log-likelihood ``theta -> sum log p(data | theta)`` of
    i.i.d. data under ``dist_builder(theta)``, closing over the data."""
    data = _data_tensor(data, device)
    fn = _iid_loglike(dist_builder)
    return lambda theta: fn(theta, data)


def regression_likelihood(dist_builder: Callable, x, y, *, device=None) -> Callable:
    """Per-point log-likelihood of regression data: ``dist_builder(theta, x)``
    is the distribution of y given x, vectorized over the data axis."""
    data = (_data_tensor(x, device), _data_tensor(y, device))
    fn = _regression_loglike(dist_builder)
    return lambda theta: fn(theta, data)


def random_domain_points(
    generator: torch.Generator, lower, upper, n: int = 100, scale: float = 100.0
) -> torch.Tensor:
    """Samples of the truncated product-Cauchy domain distribution used for
    problem validation and MCMC seeding."""
    lower = torch.as_tensor(lower)
    upper = torch.as_tensor(upper, dtype=lower.dtype, device=lower.device)
    base = Cauchy(loc=0.0, scale=scale)
    lo_c = torch.where(torch.isfinite(lower), base.cdf(lower), torch.zeros_like(lower))
    hi_c = torch.where(torch.isfinite(upper), base.cdf(upper), torch.ones_like(upper))
    u = torch.rand((n, lower.shape[0]), generator=generator, dtype=lower.dtype,
                   device=generator.device)
    u = 1e-7 + (1.0 - 2e-7) * u
    return base.icdf(lo_c + u * (hi_c - lo_c))


def validate_problem(problem: InferenceProblem, generator=None, n: int = 100) -> None:
    """Evaluate both raw densities on random domain points; raise unless all
    results are real numbers and not all of them are log-zero."""
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    pts = random_domain_points(generator, problem.lower, problem.upper, n)
    ll = problem.raw_log_likelihood(pts)
    lp = problem._batched(problem.log_prior, pts)
    for name, vals in (("log_likelihood", ll), ("log_prior", lp)):
        if vals.shape != (n,):
            raise ValueError(f"{name} must map [d]->scalar; got batch shape {tuple(vals.shape)}")
        if bool(torch.isnan(vals).any()):
            raise ValueError(f"{name} returned NaN on domain points")
        if bool((vals <= 0.5 * log_zero(vals.dtype)).all()):
            raise ValueError(
                f"{name} is log-zero on ALL {n} random domain points — "
                "check bounds/constraints"
            )


def _accepts_theta_and_data(fn: Callable) -> bool:
    try:
        sig_params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return True  # builtins/partials: assume data-aware
    if any(q.kind is inspect.Parameter.VAR_POSITIONAL for q in sig_params):
        return True
    required = [
        q for q in sig_params
        if q.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
        and q.default is inspect.Parameter.empty
    ]
    return len(required) == 2


def define_inference_problem(
    *,
    parameters: Sequence,
    log_likelihood: Optional[Callable] = None,
    likelihood: Optional[Callable] = None,
    data=None,
    independent_variables=None,
    log_prior: Optional[Callable] = None,
    prior_distribution=None,
    constraint: Optional[Callable] = None,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    batched_likelihood: bool = False,
    **metadata,
) -> InferenceProblem:
    """Canonicalize and validate a problem spec.

    Exactly one likelihood spec: ``log_likelihood`` (theta -> scalar, or
    (theta, data) -> scalar with ``data=``), or ``likelihood``, a
    distribution builder (theta -> Distribution with ``data`` only, an
    i.i.d. model; (theta, x) -> Distribution over y with
    ``independent_variables``, a regression model).

    Exactly one prior spec: ``log_prior`` or ``prior_distribution`` (a
    Distribution over the parameter vector, or one ignorance spec per
    parameter: "location", "scale" or a Distribution).

    The problem lives on the device and in the float dtype of ``data`` when
    data is given, else on ``device`` in ``dtype``.  Without either,
    ``device`` is the CUDA card (raising where there is none; pass
    ``device="cpu"`` for the host) and ``dtype`` PyTorch's default.

    ``batched_likelihood=True`` is for the engines whose likelihood runs a
    host loop over a batch (the latent-GP classifier's Newton and EP
    loops): the problem hands ``log_likelihood`` the whole batch [B, d]
    and takes [B] back, instead of mapping a per-point callable with
    ``torch.func.vmap``.
    """
    params = _as_param_specs(parameters)
    names = tuple(p.name for p in params)
    ref = _first_tensor(data) if data is not None else None
    if ref is None and isinstance(independent_variables, torch.Tensor):
        ref = independent_variables
    if ref is not None:
        device = ref.device if device is None else device
        if dtype is None and ref.is_floating_point():
            dtype = ref.dtype
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    as_t = lambda t: torch.as_tensor(t, device=device)  # noqa: E731
    lower = torch.tensor([p.low for p in params], dtype=dtype, device=device)
    upper = torch.tensor([p.high for p in params], dtype=dtype, device=device)

    problem_data = None
    if log_likelihood is None:
        if likelihood is None:
            raise ValueError("need log_likelihood or likelihood")
        if data is None:
            raise ValueError("regression model needs data (the y values)"
                             if independent_variables is not None else "iid model needs data")
        if independent_variables is not None:
            problem_data = (as_t(independent_variables), as_t(data))
            log_likelihood = _regression_loglike(likelihood)
        else:
            problem_data = as_t(data)
            log_likelihood = _iid_loglike(likelihood)
    elif data is not None:
        if independent_variables is not None:
            raise ValueError(
                "independent_variables= is only combined with the "
                "likelihood= builder form; for a custom (theta, data) "
                "log_likelihood pack the inputs yourself, e.g. data=(x, y)"
            )
        if not _accepts_theta_and_data(log_likelihood):
            raise ValueError(
                "data= needs a log_likelihood with exactly two required "
                "positional parameters (theta, data); drop data= to close "
                "over the observations instead"
            )
        problem_data = _tree_map(as_t, data)

    prior_dist = None
    if log_prior is None:
        if prior_distribution is None:
            prior_distribution = ImproperUniform(dim=len(params))
        if isinstance(prior_distribution, (list, tuple)):
            prior_dist = ignorance_prior(prior_distribution, params, dtype=dtype, device=device)
        else:
            prior_dist = prior_distribution
            plo, phi = prior_dist.support()
            plo = torch.broadcast_to(torch.as_tensor(plo, dtype=dtype, device=device), lower.shape)
            phi = torch.broadcast_to(torch.as_tensor(phi, dtype=dtype, device=device), upper.shape)
            if bool((plo > lower).any() | (phi < upper).any()):
                warnings.warn(
                    "prior support does not cover the full parameter box; "
                    "bounds tightened to the prior domain (the evidence is "
                    "relative to the prior restricted to the box)",
                    stacklevel=2,
                )
            lower = torch.maximum(lower, plo)
            upper = torch.minimum(upper, phi)
        if prior_dist.event_shape not in ((len(params),), ()):
            raise ValueError("prior distribution dimension does not match parameters")
        if prior_dist.event_shape == ():
            if len(params) != 1:
                raise ValueError("scalar prior given for a multi-parameter problem")
            log_prior = functools.partial(_first_coordinate_log_prob, prior_dist)
        else:
            log_prior = prior_dist.log_prob
    elif prior_distribution is not None:
        raise ValueError("give either log_prior or prior_distribution")

    problem = InferenceProblem(
        lower=lower,
        upper=upper,
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        param_names=names,
        prior_distribution=prior_dist,
        constraint=constraint,
        metadata=dict(metadata) if metadata else None,
        data=problem_data,
        batched_likelihood=batched_likelihood,
    )
    if validate:
        validate_problem(problem, generator=generator)
    return problem
