"""Laplace approximation for latent Gaussian processes (port of
``bayesianinference_tpu.ops.gp_laplace``).

A latent GP f ~ N(0, K), y_i ~ p(y_i | f_i) with a log-concave likelihood
gets the Laplace-approximate marginal likelihood (Rasmussen & Williams
2006, ch. 3): Newton iterations find the posterior mode f_hat, and

    log q(y | X, theta) = -a^T f_hat / 2 + log p(y | f_hat) - sum_i log L_ii,
    B = I + W^1/2 K W^1/2 = L L^T,   W = -grad^2 log p(y | f_hat).

Everything works over an explicit batch axis: ``k`` is [..., n, n] and
each matrix of the batch is one lane.  The Newton loop is a host loop over
the whole batch: a lane whose step fell below the tolerance (or that hit
``maxiter``) is frozen, and the loop ends when no lane moves, with one host
read per iteration.  Each lane's f_hat, a, logML and iteration count are
those of the JAX function on that lane alone (its ``lax.while_loop`` under
``vmap`` freezes lanes the same way).  The loop runs without a graph, so it
cannot run under ``torch.func.vmap``; the classifier's problem hands it its
whole batch instead (``engines/gp_classify.py``).  Every Cholesky here, of
B in each Newton step, goes through the ``cholesky`` op, so on the card
through the hand-written kernel.

The hyperparameter gradient is the JAX package's closed-form implicit
gradient in K (GPML eqs. 5.21-5.23), a :class:`torch.autograd.Function`:

    dlogZ/dK = (a a^T - R)/2 + m a^T,   R = W^1/2 B^-1 W^1/2,
    m = b - R (K b),   b_i = diag(K - K R K)_i d^3 log p(y_i | f_i) / 2.

Its backward is plain differentiable torch ops on its inputs.  When a
gradient is wanted, the inputs carry a graph: one Newton step is taken
from the detached mode with the graph on, and its result enters as
``f_hat + (f1 - f1.detach())`` (the mode's value, the step's graph).  At a
Newton fixed point the step's derivative in f vanishes, so its derivative
in K is the implicit derivative, and a second derivative (the Laplace
engine's Hessian, reverse over reverse) sees how the mode moves with K, as
``jax.hessian`` sees it by differentiating forward through the loop.

Per-point likelihood derivatives (d1, d2, d3) come from nested
``torch.func.grad`` of the scalar ``log_prob`` under ``torch.func.vmap``,
as the JAX package takes them by nested ``jax.grad``.  The Bernoulli
(logit and probit) and Poisson likelihoods carry their closed forms
instead (``pointwise``): they are the hot path of every Newton step, and
``torch.special.log_ndtr`` has no batching rule under ``torch.func.vmap``
(it would fall back to a loop over elements).

A failed Cholesky (non-PD B from absurd hyperparameters) yields NaN, which
the problem layer's density guard maps to the finite log-zero sentinel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.numerics import as_float, ndtr
from .gp_kernels import _inv_from_chol, cholesky

__all__ = [
    "LatentLikelihood",
    "bernoulli_logit_likelihood",
    "bernoulli_probit_likelihood",
    "binomial_logit_likelihood",
    "gamma_log_likelihood",
    "negative_binomial_likelihood",
    "ordinal_logit_likelihood",
    "poisson_log_likelihood",
    "latent_likelihood",
    "gp_laplace_mode",
    "gp_laplace_log_marginal",
    "gp_laplace_latent_moments",
    "gauss_hermite_expectation",
]


def _over_points(fn: Callable) -> Callable:
    """A scalar ``fn(f, y)`` mapped over f [..., n] and y [n] (or [n, k]):
    ``torch.func.vmap`` over the points, then over the leading dims."""
    inner = torch.func.vmap(torch.func.vmap(fn, in_dims=(0, 0)), in_dims=(0, None))

    def apply(f, y):
        flat = f.reshape(-1, f.shape[-1])
        return inner(flat, y).reshape(f.shape)

    return apply


@dataclasses.dataclass(frozen=True)
class LatentLikelihood:
    """A per-point observation model p(y_i | f_i) for a latent GP.

    ``log_prob(f, y) -> scalar`` (torch ops on one latent value and one
    target) must be log-concave in f (W >= 0) for the Newton mode to be
    globally convergent; ``link(f)`` maps latent values (elementwise, any
    shape) to the predictive quantity of interest.  Derivatives come from
    autodiff; ``pointwise``, where given, is a tuple of closed forms
    (log p, d1, d2, d3), each ``(f [..., n], y [n]) -> [..., n]``
    broadcasting over f's leading dims, which replaces the autodiff."""

    log_prob: Callable  # (f_scalar, y_scalar) -> scalar
    link: Callable  # f -> prediction scale, elementwise
    name: str = "custom"
    pointwise: Optional[tuple] = None

    def _derivs(self):
        """(lp, d1, d2, d3), each ``(f [..., n], y) -> [..., n]``."""
        if self.pointwise is not None:
            return self.pointwise
        d1 = torch.func.grad(self.log_prob, argnums=0)
        d2 = torch.func.grad(d1, argnums=0)
        d3 = torch.func.grad(d2, argnums=0)
        return tuple(_over_points(fn) for fn in (self.log_prob, d1, d2, d3))


def latent_likelihood(log_prob: Callable, link: Callable, name="custom"):
    """Wrap a scalar ``log p(y|f)`` + link into a :class:`LatentLikelihood`."""
    return LatentLikelihood(log_prob=log_prob, link=link, name=name)


def _logsig(x):
    return torch.nn.functional.logsigmoid(x)


def _logit_lp(f, y):
    return y * _logsig(f) + (1.0 - y) * _logsig(-f)


_LOGIT = (
    _logit_lp,
    lambda f, y: y * torch.sigmoid(-f) - (1.0 - y) * torch.sigmoid(f),
    lambda f, y: -torch.sigmoid(f) * torch.sigmoid(-f),
    lambda f, y: torch.sigmoid(f) * torch.sigmoid(-f) * torch.tanh(0.5 * f),  # -s(1-s)(s(-f) - s(f))
)


def bernoulli_logit_likelihood() -> LatentLikelihood:
    """y in {0, 1}; p(y=1|f) = sigmoid(f) (GPML eq. 3.2, logistic)."""
    return LatentLikelihood(_logit_lp, torch.sigmoid, "bernoulli_logit", pointwise=_LOGIT)


def _probit_lp(f, y):
    return torch.special.log_ndtr(torch.where(y > 0.5, f, -f))


def _mills(f, y):
    """(sign, z = sign f, r = phi(z) / Phi(z)), sign = +1 for y = 1, -1 for 0."""
    sign = torch.where(y > 0.5, 1.0, -1.0).to(f.dtype)
    z = sign * f
    return sign, z, torch.exp(-0.5 * z * z - torch.special.log_ndtr(z)) / math.sqrt(2.0 * math.pi)


def _probit_d1(f, y):
    sign, _, r = _mills(f, y)
    return sign * r


def _probit_d2(f, y):
    _, z, r = _mills(f, y)
    return -r * (z + r)


def _probit_d3(f, y):
    sign, z, r = _mills(f, y)
    return sign * r * ((z + r) * (z + 2.0 * r) - 1.0)


def bernoulli_probit_likelihood() -> LatentLikelihood:
    """y in {0, 1}; p(y=1|f) = Phi(f) (GPML eq. 3.2, probit).  Closed-form
    derivatives of log Phi(z), z = +-f, through the inverse Mills ratio
    r = phi(z) / Phi(z): dz = r, dz^2 = -r (z + r), dz^3 = r ((z + r)(z + 2 r) - 1)."""
    return LatentLikelihood(_probit_lp, ndtr, "bernoulli_probit",
                            pointwise=(_probit_lp, _probit_d1, _probit_d2, _probit_d3))


def _poisson_lp(f, y):
    return y * f - torch.exp(f) - torch.lgamma(y + 1.0)


def poisson_log_likelihood() -> LatentLikelihood:
    """y in {0, 1, ...}; y | f ~ Poisson(exp(f)): GP count regression."""
    return LatentLikelihood(_poisson_lp, torch.exp, "poisson_log", pointwise=(
        _poisson_lp, lambda f, y: y - torch.exp(f), lambda f, y: -torch.exp(f), lambda f, y: -torch.exp(f)))


def negative_binomial_likelihood(dispersion: float) -> LatentLikelihood:
    """y in {0, 1, ...}; y | f ~ NegBinomial(mean = exp(f), dispersion r):
    overdispersed GP count regression, Var = mu + mu^2/r.  Log-concave in
    f for any r > 0."""
    r = float(dispersion)
    if r <= 0:
        raise ValueError(f"dispersion must be positive, got {r}")
    const = -math.lgamma(r) + r * math.log(r)
    log_r = math.log(r)

    def lp(f, y):
        return (torch.lgamma(y + r) - torch.lgamma(y + 1.0) + const + y * f
                - (y + r) * torch.logaddexp(torch.full_like(f, log_r), f))

    return LatentLikelihood(lp, torch.exp, "negative_binomial")


def gamma_log_likelihood(shape: float) -> LatentLikelihood:
    """y > 0; y | f ~ Gamma(shape a, mean exp(f)): positive continuous GP
    regression.  Log-concave in f: the Hessian is -a y e^{-f} < 0."""
    a = float(shape)
    if a <= 0:
        raise ValueError(f"shape must be positive, got {a}")
    const = a * math.log(a) - math.lgamma(a)

    def lp(f, y):
        return const + (a - 1.0) * torch.log(y) - a * f - a * y * torch.exp(-f)

    return LatentLikelihood(lp, torch.exp, "gamma_log")


def ordinal_logit_likelihood(cutpoints) -> LatentLikelihood:
    """Ordered categories y in {0, ..., K} via the cumulative-logit model
    with FIXED cutpoints c_1 < ... < c_K:

        P(y <= k | f) = sigmoid(c_{k+1} - f),
        p(y = k | f)  = sigmoid(c_{k+1} - f) - sigmoid(c_k - f),

    log-concave in f.  ``link`` returns the expected category E[y | f]."""
    c_np = np.asarray(cutpoints, dtype=float)
    if c_np.ndim != 1 or c_np.shape[0] < 1:
        raise ValueError("need a 1-D array of at least one cutpoint")
    if bool(np.any(np.diff(c_np) <= 0)):
        raise ValueError("cutpoints must be strictly increasing")
    c = torch.as_tensor(c_np, dtype=torch.float64)
    cats = torch.arange(c.shape[0] + 1)
    lo = torch.cat([torch.zeros(1, dtype=torch.float64), c])  # category k's lower cut c_k (c_0 = -inf)
    hi = torch.cat([c, torch.zeros(1, dtype=torch.float64)])  # and upper cut c_{k+1} (c_{K+1} = +inf)

    def lp(f, y):
        # the cuts of category y by a mask over the categories, not an index
        # (indexing by a batched tensor has no batching rule)
        on = dict(dtype=f.dtype, device=f.device)
        pick = cats.to(device=f.device) == y.to(torch.int64)
        a = torch.where(y < 0.5, -math.inf, torch.where(pick, lo.to(**on), 0.0).sum()) - f  # lower cut minus latent
        b = torch.where(y > c.shape[0] - 0.5, math.inf, torch.where(pick, hi.to(**on), 0.0).sum()) - f
        safe_a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        safe_b = torch.where(torch.isfinite(b), b, torch.zeros_like(b))
        # log(sig(b) - sig(a)) = log_sig(b) + log_sig(-a) + log1p(-e^{a-b})
        interior = (_logsig(safe_b) + _logsig(-safe_a)
                    + torch.log1p(-torch.exp(torch.clamp(safe_a - safe_b, max=-1e-12))))
        low_cat = _logsig(safe_b)  # P(y=0) = sig(c_1 - f)
        high_cat = _logsig(-safe_a)  # P(y=K) = sig(f - c_K)
        return torch.where(torch.isinf(a), low_cat, torch.where(torch.isinf(b), high_cat, interior))

    def link(f):
        # E[y | f] = sum_k P(y > k) over the cutpoints
        return torch.sum(torch.sigmoid(f[..., None] - c.to(dtype=f.dtype, device=f.device)), dim=-1)

    return LatentLikelihood(lp, link, "ordinal_logit")


def binomial_logit_likelihood() -> LatentLikelihood:
    """Per-point binomial counts: each target row is ``[successes,
    trials]`` (y as an [n, 2] array); p(success | f) = sigmoid(f)."""

    def lp(f, y):
        s, t = y[0], y[1]
        return (torch.lgamma(t + 1.0) - torch.lgamma(s + 1.0) - torch.lgamma(t - s + 1.0)
                + s * _logsig(f) + (t - s) * _logsig(-f))

    return LatentLikelihood(lp, torch.sigmoid, "binomial_logit")


def _default_tol(dtype) -> float:
    """Newton step tolerance at the dtype's AD noise floor (the same rule
    as the JAX package's)."""
    return 1e-8 if dtype == torch.float64 else 1e-4


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _b_factor(k: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of B = I + S K S, S = diag(sw), by the ``cholesky`` op."""
    b = sw.unsqueeze(-1) * k * sw.unsqueeze(-2)
    b.diagonal(dim1=-2, dim2=-1).add_(1.0)  # a fresh product: adding I in place saves a pass
    return cholesky(b)


def _newton_state(k, y, derivs, f):
    """One stable Newton evaluation at f [B, n]: (f_new, W, sqrtW, L, a)."""
    _, d1f, d2f, _ = derivs
    w = torch.clamp(-d2f(f, y), min=0.0)  # log-concave => >= 0; clip AD dust
    sw = torch.sqrt(w)
    ell = _b_factor(k, sw)
    b = w * f + d1f(f, y)
    u = torch.cholesky_solve((sw * _mv(k, b)).unsqueeze(-1), ell).squeeze(-1)  # B^-1 S K b
    a = b - sw * u
    return _mv(k, a), w, sw, ell, a


class NewtonResult(NamedTuple):
    """The Newton loop's end point on every lane of a batch."""

    f: torch.Tensor  # [B, n] the mode f_hat
    a: torch.Tensor  # [B, n] K^-1 f_hat
    iterations: torch.Tensor  # [B] int32 Newton steps taken


def _newton_loop(k, y, derivs, maxiter: int, tol: float) -> NewtonResult:
    """GPML Algorithm 3.1 on every lane of ``k`` [B, n, n], without a graph.

    Each lane stops as the JAX ``while_loop`` does (a step's largest change
    at most ``tol``, a NaN change, or ``maxiter`` steps); a stopped lane
    keeps its values while the others go on.  One host read per step."""
    bsz, n = k.shape[0], k.shape[-1]
    with torch.no_grad():
        f = torch.zeros((bsz, n), dtype=k.dtype, device=k.device)
        a = torch.zeros_like(f)
        delta = torch.full((bsz,), math.inf, dtype=k.dtype, device=k.device)
        it = torch.zeros((bsz,), dtype=torch.int32, device=k.device)
        while True:
            active = (it < maxiter) & (delta > tol)
            if not bool(active.any()):
                break
            f_new, _, _, _, a_new = _newton_state(k, y, derivs, f)
            # a NaN change (failed factorization) stops the lane; its NaN f_hat propagates
            d = torch.nan_to_num((f_new - f).abs().amax(dim=-1), nan=0.0)
            f = torch.where(active[:, None], f_new, f)
            a = torch.where(active[:, None], a_new, a)
            delta = torch.where(active, d, delta)
            it = it + active.to(torch.int32)
    return NewtonResult(f, a, it)



def _flat(k, y):
    k = torch.as_tensor(k)
    k = k if k.is_floating_point() else k.to(torch.get_default_dtype())
    n = k.shape[-1]
    y = torch.as_tensor(y, dtype=k.dtype, device=k.device)
    return k.reshape(-1, n, n), y, k.shape[:-2]


def gp_laplace_mode(k, y, lik: LatentLikelihood, maxiter: int = 50, tol=None):
    """Newton mode of the latent posterior (GPML Algorithm 3.1) on every
    matrix of ``k`` [..., n, n].  Returns (f_hat, a = K^-1 f_hat), each
    [..., n]."""
    kf, y, lead = _flat(k, y)
    tol = _default_tol(kf.dtype) if tol is None else tol
    res = _newton_loop(kf, y, lik._derivs(), int(maxiter), tol)
    n = kf.shape[-1]
    return res.f.reshape(*lead, n), res.a.reshape(*lead, n)


def _laplace_value(a, f_hat, lp_sum, ell):
    """-a^T f_hat / 2 + log p(y | f_hat) - sum_i log L_ii (GPML eq. 3.32)."""
    return -0.5 * (a * f_hat).sum(dim=-1) + lp_sum - torch.log(torch.diagonal(ell, dim1=-2, dim2=-1)).sum(dim=-1)


class _LaplaceLogML(torch.autograd.Function):
    """The Laplace logML at the mode with the JAX package's closed-form
    implicit gradient in K (module docstring).

    Inputs (k, f_hat, a, lp_sum, sw, ell, d3): the mode, K^-1 f_hat, the
    summed log-likelihood, W^1/2, the factor of B and d^3 log p at the mode,
    all carrying their dependence on K (the module docstring says how).
    The forward reads the values; the backward gives the gradient for
    ``k`` alone, in differentiable ops on the inputs, so that
    differentiating it again sees the mode move."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k, f_hat, a, lp_sum, sw, ell, d3):
        return _laplace_value(a, f_hat, lp_sum, ell)

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, f_hat, a, _, sw, ell, d3 = inputs
        ctx.save_for_backward(k, a, sw, ell, d3)

    @staticmethod
    def backward(ctx, g):
        k, a, sw, ell, d3 = ctx.saved_tensors
        r = sw.unsqueeze(-1) * _inv_from_chol(ell) * sw.unsqueeze(-2)
        # explicit part: d/dK of (-a^T f_hat / 2 - log|B| / 2) at fixed f_hat
        explicit = 0.5 * (a.unsqueeze(-1) * a.unsqueeze(-2) - r)
        # implicit part through f_hat(K): diag of C = (K^-1 + W)^-1 = K - K R K
        c_diag = torch.diagonal(k, dim1=-2, dim2=-1) - torch.sum(k * (r @ k).mT, dim=-1)
        b_vec = 0.5 * c_diag * d3
        m = b_vec - _mv(r, _mv(k, b_vec))  # (I + W K)^-T b via Woodbury
        dk = g[..., None, None] * (explicit + m.unsqueeze(-1) * a.unsqueeze(-2))
        return dk, None, None, None, None, None, None


def _straight_through(value: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``value`` exactly, with the gradient of ``graph``."""
    return value + (graph - graph.detach())


def gp_laplace_log_marginal(k, y, lik: LatentLikelihood, maxiter: int = 50, tol=None) -> torch.Tensor:
    """Laplace-approximate log marginal likelihood log q(y | X, theta)
    (GPML eq. 3.32) of every matrix of ``k`` [..., n, n], with the exact
    closed-form gradient in K.  ``k`` is symmetrized on entry, as in the
    JAX package.  Returns [...]."""
    kf, y, lead = _flat(k, y)
    tol = _default_tol(kf.dtype) if tol is None else float(tol)
    kf = 0.5 * (kf + kf.mT)
    derivs = lik._derivs()
    lpf, d2f, d3f = derivs[0], derivs[2], derivs[3]
    res = _newton_loop(kf.detach(), y, derivs, int(maxiter), tol)
    if not (torch.is_grad_enabled() and kf.requires_grad):
        sw = torch.sqrt(torch.clamp(-d2f(res.f, y), min=0.0))
        out = _laplace_value(res.a, res.f, lpf(res.f, y).sum(dim=-1), _b_factor(kf, sw))
        return out.reshape(lead)
    # one Newton step from the detached mode with the graph on: the mode's
    # values, the step's derivative in K (the implicit one at a fixed point)
    f1, _, _, _, a1 = _newton_state(kf, y, derivs, res.f)
    f_hat = _straight_through(res.f, f1)
    a = _straight_through(res.a, a1)
    sw = torch.sqrt(torch.clamp(-d2f(f_hat, y), min=0.0))
    out = _LaplaceLogML.apply(kf, f_hat, a, lpf(f_hat, y).sum(dim=-1), sw, _b_factor(kf, sw), d3f(f_hat, y))
    return out.reshape(lead)


def gp_laplace_latent_moments(k, y, lik: LatentLikelihood, k_cross, k_query_diag, maxiter=50, tol=None):
    """Latent predictive moments at query points (GPML eqs. 3.21-3.24):

        mu*    = k*^T grad log p(y | f_hat)
        sig*^2 = k** - || L^-1 (W^1/2 k*) ||^2

    ``k`` [..., n, n], ``k_cross`` [..., n, q], ``k_query_diag`` [..., q].
    Returns (mu [..., q], var [..., q]); no gradient."""
    with torch.no_grad():
        kf, y, lead = _flat(k, y)
        n = kf.shape[-1]
        tol = _default_tol(kf.dtype) if tol is None else tol
        derivs = lik._derivs()
        res = _newton_loop(kf, y, derivs, int(maxiter), tol)
        sw = torch.sqrt(torch.clamp(-derivs[2](res.f, y), min=0.0))
        ell = _b_factor(kf, sw)
        kc = torch.as_tensor(k_cross, dtype=kf.dtype, device=kf.device)
        kc = kc.expand(*lead, *kc.shape[-2:]).reshape(-1, n, kc.shape[-1])
        mu = (kc.mT @ res.a.unsqueeze(-1)).squeeze(-1)
        v = torch.linalg.solve_triangular(ell, sw.unsqueeze(-1) * kc, upper=False)
        kqd = torch.as_tensor(k_query_diag, dtype=kf.dtype, device=kf.device).reshape(mu.shape)
        var = torch.clamp(kqd - (v * v).sum(dim=-2), min=0.0)
        q = mu.shape[-1]
        return mu.reshape(*lead, q), var.reshape(*lead, q)


_GH_CACHE = {}


def gauss_hermite_expectation(fn: Callable, mu, var, num_points: int = 32):
    """E[fn(f)] for f ~ N(mu, var), vectorized over mu/var, by
    Gauss-Hermite quadrature: the averaged predictive (GPML eq. 3.25) for
    any link."""
    if num_points not in _GH_CACHE:
        nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
        _GH_CACHE[num_points] = (nodes, weights / np.sqrt(2.0 * np.pi))
    nodes, weights = _GH_CACHE[num_points]
    mu = as_float(mu)
    var = torch.as_tensor(var, dtype=mu.dtype, device=mu.device)
    nodes = torch.as_tensor(nodes, dtype=mu.dtype, device=mu.device)
    weights = torch.as_tensor(weights, dtype=mu.dtype, device=mu.device)
    f = mu[..., None] + torch.sqrt(var)[..., None] * nodes
    return torch.sum(fn(f) * weights, dim=-1)
