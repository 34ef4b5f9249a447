"""Scalable GP classification and count regression: the stochastic
variational GP fit (port of ``bayesianinference_tpu.engines.svgp``).

``fit_svgp`` trains the Hensman et al. (2015) sparse variational posterior
for any latent likelihood; ``fit_svgp_multiclass`` C shared-kernel latents
under a softmax; ``fit_svgp_heteroscedastic`` a latent mean and a latent
log noise.  One Adam step is one [M, M] Cholesky and [M, B] products
(B = batch), with K_zz and K_zx through the SE op and the factor through
the ``cholesky`` op (:mod:`..ops.svgp`).

The random numbers are inputs: :func:`svgp_draws` makes, with a leading
step axis, the minibatch indices (the JAX package's ``jax.random.randint``
per step) and the multiclass bound's Monte-Carlo normals; a fit takes them
as ``draws=`` (tests replay the JAX key tree that way) or makes them from
``generator``.

``fit_svgp(mesh=)`` (the port's :class:`~..parallel.sharding.Mesh`) splits
the data axis over ``mesh.shape[axis_name]`` devices: each shard's
expected log-likelihood (its K_zx block through the SE op on its device,
zero-padded rows weighted 0) is summed over the shards (the ``psum``)
before the KL term; every step is full batch.

Not ported, as TPU workarounds: the ``jax.jit`` + ``lax.scan`` one-program
Adam loops (a host loop over eager steps here, with optax's update from
:mod:`..core.optim`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..core.device import as_float_on
from ..core.optim import adam_init, adam_step
from ..core.transforms import box_bijection
from ..models.problem import _as_param_specs
from ..ops.gp_laplace import LatentLikelihood, gauss_hermite_expectation
from ..ops.svgp import (
    SVGPVariational,
    svgp_elbo,
    svgp_expected_loglik,
    svgp_hetero_elbo,
    svgp_init_variational,
    svgp_kl,
    svgp_latent_moments,
    svgp_multiclass_elbo,
    svgp_multiclass_latent_moments,
)
from .gp_classify import _NAMED_LIKELIHOODS
from .sparse_gp import select_inducing_points

__all__ = [
    "SVGPDraws",
    "SVGPFit",
    "SVGPHeteroFit",
    "SVGPMulticlassFit",
    "svgp_draws",
    "fit_svgp",
    "fit_svgp_heteroscedastic",
    "fit_svgp_multiclass",
    "predict_from_svgp",
    "predict_from_svgp_heteroscedastic",
    "predict_from_svgp_multiclass",
]

FINAL_MC = 64  # Monte-Carlo draws of the multiclass fit's full-data bound


class SVGPDraws(NamedTuple):
    """The random numbers of a fit, with a leading step axis.

    ``indices`` [steps, B] int64 minibatch rows drawn with replacement
    (None: full batch); ``normals`` [steps, S, B, C] and ``final_normals``
    [FINAL_MC, n, C] the multiclass bound's standard normals (None for
    the binary and heteroscedastic fits)."""

    indices: Optional[torch.Tensor]
    normals: Optional[torch.Tensor] = None
    final_normals: Optional[torch.Tensor] = None


def svgp_draws(generator: torch.Generator, steps: int, n: int, minibatch: Optional[int] = None, *,
               num_mc: int = 0, num_classes: int = 0, dtype=torch.float32) -> SVGPDraws:
    """A fit's draws from ``generator`` (on its device): uniform minibatch
    indices in [0, n) per step, and with ``num_mc`` and ``num_classes``
    the multiclass normals per step and for the final bound."""
    dev = generator.device
    indices = None if minibatch is None else torch.randint(0, n, (steps, minibatch), generator=generator, device=dev)
    if not num_mc:
        return SVGPDraws(indices)
    batch = n if minibatch is None else minibatch
    normals = torch.randn((steps, num_mc, batch, num_classes), generator=generator, dtype=dtype, device=dev)
    final = torch.randn((FINAL_MC, n, num_classes), generator=generator, dtype=dtype, device=dev)
    return SVGPDraws(indices, normals, final)


def _points(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.atleast_2d(torch.as_tensor(x, dtype=ref.dtype, device=ref.device))


@dataclasses.dataclass(frozen=True)
class SVGPFit:
    """A trained SVGP: point hyperparameters and the variational posterior.
    ``elbo`` is the full-data bound at the optimum, ``elbo_trace`` the
    per-step (minibatch) values."""

    theta: torch.Tensor  # [d]
    z: torch.Tensor  # [M, q] inducing inputs
    variational: SVGPVariational
    elbo: torch.Tensor  # scalar, full data
    elbo_trace: torch.Tensor  # [steps]
    kernel_builder: Callable = dataclasses.field(repr=False)
    likelihood: LatentLikelihood = dataclasses.field(repr=False)
    jitter: Optional[float] = None  # relative; None = the dtype's default

    def latent_moments(self, x_query):
        """q(f*) mean and variance at query points."""
        return svgp_latent_moments(self.kernel_builder(self.theta), _points(x_query, self.z), self.z,
                                   self.variational, self.jitter)


class _Setup(NamedTuple):
    x: torch.Tensor
    n: int
    bij: object
    u0: torch.Tensor
    z0: torch.Tensor
    scale: float


def _setup(x, parameters, inducing, inducing_method, initial_theta, minibatch, generator, device) -> _Setup:
    x = torch.atleast_2d(as_float_on(x, device))
    n = x.shape[0]
    specs = _as_param_specs(parameters)
    on = dict(dtype=x.dtype, device=x.device)
    bij = box_bijection(torch.tensor([s.low for s in specs], **on), torch.tensor([s.high for s in specs], **on))
    u0 = bij.to_z(torch.as_tensor(initial_theta, **on)) if initial_theta is not None else torch.zeros(
        (len(specs),), **on)
    if isinstance(inducing, int):
        z0 = select_inducing_points(x, inducing, inducing_method, generator)
    else:
        z0 = torch.atleast_2d(torch.as_tensor(inducing, **on))
    if minibatch is not None and not 0 < minibatch <= n:
        raise ValueError(f"minibatch must be in (0, {n}], got {minibatch}")
    return _Setup(x, n, bij, u0, z0, 1.0 if minibatch is None else n / minibatch)


def _fit_draws(draws, generator, steps, n, minibatch, x, **mc) -> SVGPDraws:
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        draws = svgp_draws(generator, steps, n, minibatch, dtype=x.dtype, **mc)
    move = lambda t: None if t is None else t.to(x.device)  # noqa: E731
    draws = SVGPDraws(*(move(t) for t in draws))
    if (draws.indices is None) != (minibatch is None):
        raise ValueError("draws.indices must be given exactly when minibatch is")
    return draws


def _adam_loop(params, batch_elbo, steps, learning_rate, optimize_inducing):
    """``steps`` Adam ascent steps of ``batch_elbo(params, step)``; the
    inducing inputs ``z`` move only with ``optimize_inducing``.  Returns
    (params, trace of the bound before each step)."""
    state, trace = adam_init(params), []
    for step in range(steps):
        with torch.enable_grad():
            live = {k: v.detach().requires_grad_(k != "z" or optimize_inducing) for k, v in params.items()}
            value = batch_elbo(live, step)
            names = [k for k, v in live.items() if v.requires_grad]
            grads = dict(zip(names, torch.autograd.grad(value, [live[k] for k in names], allow_unused=True)))
        # ascent: the negated gradient, zero for what the bound does not use
        g = {k: torch.zeros_like(v) if grads.get(k) is None else -grads[k] for k, v in params.items()}
        trace.append(value.detach())
        params, state = adam_step(params, g, state, learning_rate)
    ref = params["u"]
    return params, torch.stack(trace) if trace else torch.zeros((0,), dtype=ref.dtype, device=ref.device)


def fit_svgp(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    likelihood="bernoulli_logit",
    inducing=128,
    inducing_method: str = "farthest",
    steps: int = 500,
    learning_rate: float = 0.05,
    minibatch: Optional[int] = None,
    num_quad_points: int = 20,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SVGPDraws] = None,
    mesh=None,
    axis_name: str = "data",
    device=None,
) -> SVGPFit:
    """Train an SVGP: hyperparameters (through the box bijection of
    ``parameters``, (name, low, high) each), inducing inputs and the
    variational posterior jointly by Adam.

    ``inducing``: an int M (selected from the data by ``inducing_method``,
    ``"random"`` drawing with ``generator``) or an explicit [M, q] array.
    ``minibatch``: batch size of the stochastic steps (default: full
    batch); the reported ``elbo`` is always the full-data bound.  The
    minibatch indices come from ``draws`` ([steps, B], :func:`svgp_draws`)
    or from ``generator`` (default: seed 0 on the data's device).  x [n, q]
    that is not a tensor goes to ``device``, the card unless it names the
    CPU.  ``mesh``: the data axis split over ``mesh.shape[axis_name]``
    devices (full-batch steps)."""
    if mesh is not None and minibatch is not None:
        raise ValueError("minibatch and mesh are mutually exclusive (a device's data shard already is its batch)")
    if isinstance(likelihood, str):
        try:
            likelihood = _NAMED_LIKELIHOODS[likelihood]()
        except KeyError:
            raise ValueError(f"unknown likelihood {likelihood!r}; expected one of "
                             f"{sorted(_NAMED_LIKELIHOODS)} or a LatentLikelihood") from None
    s = _setup(x, parameters, inducing, inducing_method, initial_theta, minibatch, generator, device)
    x = s.x
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"need x [n, d] and y [n(, k)]; got {tuple(x.shape)} and {tuple(y.shape)}")
    draws = _fit_draws(draws, generator, steps, s.n, minibatch, x)
    var0 = svgp_init_variational(s.z0.shape[0], x.dtype, device=x.device)

    def elbo(params, xb, yb, data_scale):
        var = SVGPVariational(m=params["m"], raw_scale=params["raw"])
        return svgp_elbo(kernel_builder(s.bij.to_x(params["u"])), xb, yb, params["z"], likelihood, var,
                         jitter=jitter, num_quad_points=num_quad_points, data_scale=data_scale)

    def batch_elbo(params, step):
        if draws.indices is None:
            return elbo(params, x, y, s.scale)
        idx = draws.indices[step]
        return elbo(params, x[idx], y[idx], s.scale)

    if mesh is not None:
        from ..parallel.sharding import axis_blocks, check_mesh, sum_to

        blocks = list(zip(*axis_blocks(check_mesh(mesh, "fit_svgp"), axis_name, x, y)))

        def elbo(params, *_):
            kernel = kernel_builder(s.bij.to_x(params["u"]))
            ell = sum_to([svgp_expected_loglik(
                kernel, xs, ys, params["z"].to(xs.device), likelihood,
                SVGPVariational(m=params["m"].to(xs.device), raw_scale=params["raw"].to(xs.device)),
                jitter=jitter, num_quad_points=num_quad_points, point_weights=ws) for xs, ys, ws in blocks],
                params["m"].device)
            return ell - svgp_kl(SVGPVariational(m=params["m"], raw_scale=params["raw"]))

        def batch_elbo(params, step):
            return elbo(params)

    params0 = {"u": s.u0, "z": s.z0, "m": var0.m, "raw": var0.raw_scale}
    params, trace = _adam_loop(params0, batch_elbo, steps, learning_rate, optimize_inducing)
    with torch.no_grad():
        full = elbo(params, x, y, 1.0)
    return SVGPFit(theta=s.bij.to_x(params["u"]), z=params["z"],
                   variational=SVGPVariational(m=params["m"], raw_scale=params["raw"]), elbo=full, elbo_trace=trace,
                   kernel_builder=kernel_builder, likelihood=likelihood,
                   jitter=None if jitter is None else float(jitter))


def predict_from_svgp(fit: SVGPFit, points, *, num_quad_points: int = 32):
    """Predictions at query points: (link mean, latent mu, latent std), the
    link expectation by Gauss-Hermite over q(f*)."""
    with torch.no_grad():
        mu, s2 = fit.latent_moments(points)
        p = gauss_hermite_expectation(fit.likelihood.link, mu, s2, num_quad_points)
    return p, mu, torch.sqrt(s2)


@dataclasses.dataclass(frozen=True)
class SVGPMulticlassFit:
    """A trained softmax SVGP: C shared-kernel latents, one variational
    Gaussian per class."""

    theta: torch.Tensor  # [d]
    z: torch.Tensor  # [M, q]
    m: torch.Tensor  # [C, M]
    raw_scale: torch.Tensor  # [C, M, M]
    elbo: torch.Tensor  # scalar, full data (its own Monte-Carlo draws)
    elbo_trace: torch.Tensor  # [steps]
    num_classes: int
    kernel_builder: Callable = dataclasses.field(repr=False)
    jitter: Optional[float] = None

    def latent_moments(self, x_query):
        return svgp_multiclass_latent_moments(self.kernel_builder(self.theta), _points(x_query, self.z), self.z,
                                              self.m, self.raw_scale, self.jitter)


def fit_svgp_multiclass(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    num_classes: Optional[int] = None,
    inducing=128,
    inducing_method: str = "farthest",
    steps: int = 500,
    learning_rate: float = 0.05,
    minibatch: Optional[int] = None,
    num_mc: int = 8,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SVGPDraws] = None,
    device=None,
) -> SVGPMulticlassFit:
    """Multiclass GP classification: C latent GPs (one shared kernel) and a
    softmax likelihood, trained as an SVGP.  ``y``: integer labels [n] in
    [0, C).  The expected log-softmax takes ``num_mc`` reparameterized
    draws per step, fresh each step (``draws.normals``), and the final
    full-data bound ``FINAL_MC`` (``draws.final_normals``)."""
    s = _setup(x, parameters, inducing, inducing_method, initial_theta, minibatch, generator, device)
    x = s.x
    y = torch.as_tensor(y, device=x.device)
    if y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(f"need x [n, d] and integer labels y [n]; got {tuple(x.shape)} and {tuple(y.shape)}")
    if num_classes is None:
        if y.numel() == 0:
            raise ValueError("empty y needs explicit num_classes")
        num_classes = int(y.max()) + 1
    if num_classes < 2:
        raise ValueError(f"need at least 2 classes, got {num_classes}")
    if bool(torch.any((y < 0) | (y >= num_classes))):
        raise ValueError(f"labels must lie in [0, {num_classes})")
    y = y.to(torch.int64)
    draws = _fit_draws(draws, generator, steps, s.n, minibatch, x, num_mc=num_mc, num_classes=num_classes)
    m_ind = s.z0.shape[0]
    var0 = svgp_init_variational(m_ind, x.dtype, device=x.device)
    m0 = torch.zeros((num_classes, m_ind), dtype=x.dtype, device=x.device)
    raw0 = var0.raw_scale.expand(num_classes, m_ind, m_ind).clone()

    def elbo(params, xb, yb, normals, data_scale):
        return svgp_multiclass_elbo(kernel_builder(s.bij.to_x(params["u"])), xb, yb, params["z"], params["m"],
                                    params["raw"], normals, jitter=jitter, data_scale=data_scale)

    def batch_elbo(params, step):
        normals = draws.normals[step]
        if draws.indices is None:
            return elbo(params, x, y, normals, s.scale)
        idx = draws.indices[step]
        return elbo(params, x[idx], y[idx], normals, s.scale)

    params0 = {"u": s.u0, "z": s.z0, "m": m0, "raw": raw0}
    params, trace = _adam_loop(params0, batch_elbo, steps, learning_rate, optimize_inducing)
    with torch.no_grad():
        full = elbo(params, x, y, draws.final_normals, 1.0)
    return SVGPMulticlassFit(theta=s.bij.to_x(params["u"]), z=params["z"], m=params["m"], raw_scale=params["raw"],
                             elbo=full, elbo_trace=trace, num_classes=int(num_classes), kernel_builder=kernel_builder,
                             jitter=None if jitter is None else float(jitter))


def predict_from_svgp_multiclass(fit: SVGPMulticlassFit, points, *, num_mc: int = 512,
                                 generator: Optional[torch.Generator] = None, normals=None):
    """Class probabilities at query points: E[softmax(f*)] over the latent
    posterior by Monte Carlo, on ``normals`` [num_mc, m, C] or draws of
    ``generator`` (default: seed 0 on the fit's device).  Returns
    (probs [m, C], latent mu [m, C], latent sd [m, C])."""
    with torch.no_grad():
        mu, s2 = fit.latent_moments(points)
        if normals is None:
            if generator is None:
                generator = torch.Generator(device=mu.device).manual_seed(0)
            normals = torch.randn((num_mc, *mu.shape), generator=generator, dtype=mu.dtype, device=generator.device)
        f = mu + torch.sqrt(s2) * torch.as_tensor(normals, dtype=mu.dtype, device=mu.device)
        probs = torch.mean(torch.softmax(f, dim=-1), dim=0)
    return probs, mu, torch.sqrt(s2)


@dataclasses.dataclass(frozen=True)
class SVGPHeteroFit:
    """A trained heteroscedastic GP: latent mean GP f and latent log-noise
    GP g, sharing inducing locations."""

    theta: torch.Tensor  # [d]
    z: torch.Tensor  # [M, q]
    var_f: SVGPVariational
    var_g: SVGPVariational
    noise_bias: torch.Tensor  # scalar learned log-noise intercept
    elbo: torch.Tensor  # scalar, full data
    elbo_trace: torch.Tensor  # [steps]
    mean_kernel_builder: Callable = dataclasses.field(repr=False)
    noise_kernel_builder: Callable = dataclasses.field(repr=False)
    jitter: Optional[float] = None

    def latent_moments(self, x_query):
        """((mu_f, s2_f), (mu_g, s2_g)) at query points."""
        xq = _points(x_query, self.z)
        return (svgp_latent_moments(self.mean_kernel_builder(self.theta), xq, self.z, self.var_f, self.jitter),
                svgp_latent_moments(self.noise_kernel_builder(self.theta), xq, self.z, self.var_g, self.jitter))


def fit_svgp_heteroscedastic(
    x,
    y,
    mean_kernel_builder: Callable,
    noise_kernel_builder: Callable,
    parameters,
    *,
    inducing=64,
    inducing_method: str = "farthest",
    steps: int = 800,
    learning_rate: float = 0.03,
    minibatch: Optional[int] = None,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SVGPDraws] = None,
    device=None,
) -> SVGPHeteroFit:
    """Heteroscedastic GP regression y_i ~ N(f(x_i), exp(g(x_i))^2), latent
    GPs for the mean (f) and the log noise (g) sharing inducing locations
    (:func:`..ops.svgp.svgp_hetero_elbo`).  Both kernel builders read the
    same theta: slice the parameter box as needed."""
    s = _setup(x, parameters, inducing, inducing_method, initial_theta, minibatch, generator, device)
    x = s.x
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    if y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(f"need x [n, d] and y [n]; got {tuple(x.shape)} and {tuple(y.shape)}")
    draws = _fit_draws(draws, generator, steps, s.n, minibatch, x)
    m_ind = s.z0.shape[0]
    vf0 = svgp_init_variational(m_ind, x.dtype, device=x.device)
    # the log-noise latent sits inside e^{2 s2} moments: its scale starts
    # small, and a scalar intercept carries the average log noise
    vg0 = svgp_init_variational(m_ind, x.dtype, scale=0.01, device=x.device)
    bg0 = torch.log(torch.std(y, correction=0) + 1e-12)

    def elbo(params, xb, yb, data_scale):
        theta = s.bij.to_x(params["u"])
        return svgp_hetero_elbo(mean_kernel_builder(theta), noise_kernel_builder(theta), xb, yb, params["z"],
                                SVGPVariational(m=params["mf"], raw_scale=params["rawf"]),
                                SVGPVariational(m=params["mg"], raw_scale=params["rawg"]),
                                jitter=jitter, data_scale=data_scale, noise_bias=params["bg"])

    def batch_elbo(params, step):
        if draws.indices is None:
            return elbo(params, x, y, s.scale)
        idx = draws.indices[step]
        return elbo(params, x[idx], y[idx], s.scale)

    params0 = {"u": s.u0, "z": s.z0, "bg": bg0, "mf": vf0.m, "rawf": vf0.raw_scale, "mg": vg0.m,
               "rawg": vg0.raw_scale}
    params, trace = _adam_loop(params0, batch_elbo, steps, learning_rate, optimize_inducing)
    with torch.no_grad():
        full = elbo(params, x, y, 1.0)
    return SVGPHeteroFit(theta=s.bij.to_x(params["u"]), z=params["z"],
                         var_f=SVGPVariational(m=params["mf"], raw_scale=params["rawf"]),
                         var_g=SVGPVariational(m=params["mg"], raw_scale=params["rawg"]), noise_bias=params["bg"],
                         elbo=full, elbo_trace=trace, mean_kernel_builder=mean_kernel_builder,
                         noise_kernel_builder=noise_kernel_builder, jitter=None if jitter is None else float(jitter))


def predict_from_svgp_heteroscedastic(fit: SVGPHeteroFit, points):
    """Predictive moments at query points: (mean, total_std, noise_std,
    latent_mean_std), with total variance s_f^2 + E[e^{2g}] and
    E[e^{2g}] = e^{2 mu_g + 2 s_g^2}."""
    with torch.no_grad():
        (mu_f, s2_f), (mu_g, s2_g) = fit.latent_moments(points)
        noise_var = torch.exp(2.0 * (mu_g + fit.noise_bias) + 2.0 * s2_g)
    return mu_f, torch.sqrt(s2_f + noise_var), torch.sqrt(noise_var), torch.sqrt(s2_f)
