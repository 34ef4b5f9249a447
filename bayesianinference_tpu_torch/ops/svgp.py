"""Stochastic variational GP (SVGP) ops for non-Gaussian likelihoods (port
of ``bayesianinference_tpu.ops.svgp``).

M inducing points carry a free-form Gaussian variational posterior
(Hensman, Matthews & Ghahramani 2015), and the evidence lower bound

    ELBO = sum_i E_{q(f_i)}[log p(y_i | f_i)] - KL(q(u) || p(u))

decomposes over data points, so it minibatches.  In the whitened
parameterization u = L_zz v, q(v) = N(m, L L^T), the KL is the closed
form (||m||^2 + ||L||_F^2 - 2 sum log L_ii - M) / 2 and the latent
marginals are

    a_i = L_zz^-1 k_z(x_i)          ([M, n], one triangular solve)
    mu_i = a_i^T m
    s2_i = k_ii - ||a_i||^2 + ||L^T a_i||^2.

K_zz = ``kernel.matrix(z, z)`` and K_zx = ``kernel.matrix(z, x)`` are
calls of the ``se_covariance`` op for an SE kernel (the symmetric call for
K_zz), and K_zz's factor is the ``cholesky`` op, so on the card both run
the hand-written kernels.  ``solve_triangular`` and the matmuls stay
``torch.linalg`` and ``@``: the JAX package computes them outside any
Pallas kernel.

The expected log-likelihood is Gauss-Hermite quadrature of the
likelihood's ``log_prob``.  Where the likelihood carries its closed form
(``pointwise[0]``: Bernoulli logit and probit, Poisson), that is applied
to the [Q, n] tensor of nodes at once; a custom scalar ``log_prob`` is
mapped over the points by ``torch.func.vmap`` (``gp_laplace._over_points``),
as the JAX package's double ``vmap`` maps it.  The probit needs the closed
form: ``torch.special.log_ndtr`` has no batching rule under ``vmap``.

The variational scale is a raw [M, M] tensor mapped to a Cholesky factor
by tril + softplus diagonal.  A failed Cholesky yields NaN.  The
multiclass bound's Monte-Carlo normals are an input (``normals``), not a
key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.numerics import as_float
from .gp_kernels import Kernel, cholesky
from .gp_laplace import LatentLikelihood, _over_points

__all__ = [
    "SVGPVariational",
    "svgp_init_variational",
    "svgp_latent_moments",
    "svgp_expected_loglik",
    "svgp_elbo",
    "svgp_kl",
    "svgp_multiclass_latent_moments",
    "svgp_multiclass_elbo",
    "svgp_hetero_elbo",
    "default_jitter",
]


class SVGPVariational(NamedTuple):
    """Whitened variational parameters: q(v) = N(m, L L^T) with
    L = tril(raw) + softplus diagonal."""

    m: torch.Tensor  # [M]
    raw_scale: torch.Tensor  # [M, M] unconstrained


def svgp_init_variational(num_inducing: int, dtype=torch.float32, scale: float = 1.0, device=None):
    """m = 0, L = scale * I (raw diagonal softplus^-1(scale)).  A small
    ``scale`` suits latents inside a log-scale link (the heteroscedastic
    noise), whose expected log-likelihood carries e^{2 s2} terms."""
    inv_softplus = float(np.log(np.expm1(scale)))
    raw = torch.eye(num_inducing, dtype=dtype, device=device) * inv_softplus
    return SVGPVariational(m=torch.zeros((num_inducing,), dtype=dtype, device=device), raw_scale=raw)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _chol_from_raw(raw):
    """tril(raw, -1) + diag(softplus(diag(raw))), over any leading dims."""
    return torch.tril(raw, diagonal=-1) + torch.diag_embed(_softplus(torch.diagonal(raw, dim1=-2, dim2=-1)))


def _kl(m, raw):
    l = _chol_from_raw(raw)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    return 0.5 * (torch.sum(m**2, dim=-1) + torch.sum(l**2, dim=(-2, -1))
                  - 2.0 * torch.sum(torch.log(diag), dim=-1) - m.shape[-1])


def svgp_kl(var: SVGPVariational) -> torch.Tensor:
    """KL(q(v) || N(0, I)) in whitened coordinates: the closed form, no
    solves (Hensman et al. 2015 eq. 5 after whitening)."""
    return _kl(var.m, var.raw_scale)


def default_jitter(dtype) -> float:
    """Relative K_zz jitter at the dtype's Cholesky stability floor: 1e-6
    in float64, 1e-4 in float32."""
    return 1e-6 if dtype == torch.float64 else 1e-4


def _whitened_cross(kernel: Kernel, x, z, jitter):
    """a = L_zz^-1 K_zx [M, n], with K_zz jittered by ``jitter`` times its
    mean diagonal (relative; None: the dtype's default)."""
    dtype = z.dtype
    if jitter is None:
        jitter = default_jitter(dtype)
    k_zz = kernel.matrix(z, z)
    scale = torch.mean(torch.diagonal(k_zz)) + torch.finfo(dtype).tiny
    k_zz = k_zz + (jitter * scale) * torch.eye(z.shape[0], dtype=dtype, device=z.device)
    l_zz = cholesky(k_zz)
    return torch.linalg.solve_triangular(l_zz, kernel.matrix(z, x), upper=False)


def svgp_latent_moments(kernel: Kernel, x, z, var: SVGPVariational, jitter=None):
    """Marginal q(f_i) = N(mu_i, s2_i) at inputs ``x`` [n, q] (module
    docstring formulas).  Returns (mu [n], s2 [n]).  ``jitter`` is relative
    to the mean prior variance (None: the dtype's default)."""
    x, z = as_float(x), as_float(z)
    a = _whitened_cross(kernel, x, z, jitter)
    l_v = _chol_from_raw(var.raw_scale)
    mu = a.mT @ var.m
    la = l_v.mT @ a  # [M, n]
    s2 = kernel.diag(x) - torch.sum(a * a, dim=0) + torch.sum(la * la, dim=0)
    return mu, torch.clamp(s2, min=0.0)


_GH_CACHE = {}


def _gh(num_points: int, dtype, device):
    """Probabilists' Gauss-Hermite nodes and weights / sqrt(2 pi)."""
    if num_points not in _GH_CACHE:
        nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
        _GH_CACHE[num_points] = (nodes, weights / np.sqrt(2.0 * np.pi))
    nodes, weights = _GH_CACHE[num_points]
    return (torch.as_tensor(nodes, dtype=dtype, device=device), torch.as_tensor(weights, dtype=dtype, device=device))


def _log_prob_at_nodes(lik: LatentLikelihood, f, y):
    """log p(y_i | f[q, i]) for f [Q, n]: the closed form where the
    likelihood has one, else its scalar ``log_prob`` mapped over points."""
    if lik.pointwise is not None:
        return lik.pointwise[0](f, y)
    return _over_points(lik.log_prob)(f, y)


def svgp_expected_loglik(kernel: Kernel, x, y, z, lik: LatentLikelihood, var: SVGPVariational, jitter=None,
                         num_quad_points: int = 20, point_weights=None) -> torch.Tensor:
    """sum_i w_i E_{q(f_i)}[log p(y_i | f_i)] by Gauss-Hermite quadrature;
    ``point_weights`` (0/1 masks or fractional weights) default to 1."""
    mu, s2 = svgp_latent_moments(kernel, x, z, var, jitter)
    # the floor keeps d(sqrt)/ds2 finite where cancellation clamped s2 to 0
    s2 = torch.clamp(s2, min=torch.finfo(mu.dtype).eps)
    nodes, weights = _gh(num_quad_points, mu.dtype, mu.device)
    f = mu + torch.sqrt(s2) * nodes[:, None]  # [Q, n]
    y = torch.as_tensor(y, dtype=mu.dtype, device=mu.device)
    per_point = weights @ _log_prob_at_nodes(lik, f, y)
    if point_weights is not None:
        per_point = per_point * point_weights
    return torch.sum(per_point)


def svgp_multiclass_latent_moments(kernel: Kernel, x, z, m_all, raw_all, jitter=None):
    """Per-class marginals of C independent latent GPs sharing one kernel:
    one [M, M] Cholesky and one [M, n] solve serve every class.
    ``m_all`` [C, M], ``raw_all`` [C, M, M] -> (mu [n, C], s2 [n, C])."""
    x, z = as_float(x), as_float(z)
    a = _whitened_cross(kernel, x, z, jitter)
    mu = torch.einsum("mn,cm->nc", a, m_all)
    la = torch.einsum("cjm,jn->cmn", _chol_from_raw(raw_all), a)  # L_c^T a per class
    base = kernel.diag(x) - torch.sum(a * a, dim=0)
    s2 = base[:, None] + torch.sum(la**2, dim=1).mT
    return mu, torch.clamp(s2, min=0.0)


def svgp_multiclass_elbo(kernel: Kernel, x, y_labels, z, m_all, raw_all, normals, jitter=None,
                         data_scale: float = 1.0) -> torch.Tensor:
    """Softmax-likelihood SVGP bound for C shared-kernel latents.  The
    expected log-softmax is the reparameterized Monte-Carlo estimate over
    ``normals`` [S, n, C] (standard normal draws, the JAX function's
    ``jax.random.normal(key, (num_mc, n, C))``); the KL sums the per-class
    closed forms."""
    mu, s2 = svgp_multiclass_latent_moments(kernel, x, z, m_all, raw_all, jitter)
    s = torch.sqrt(torch.clamp(s2, min=torch.finfo(mu.dtype).eps))
    f = mu + s * normals  # [S, n, C]
    logp = torch.log_softmax(f, dim=-1)
    labels = torch.as_tensor(y_labels, device=mu.device).to(torch.int64)
    picked = torch.gather(logp, -1, labels[None, :, None].expand(f.shape[0], -1, 1))[..., 0]
    ell = torch.mean(torch.sum(picked, dim=-1))
    return data_scale * ell - torch.sum(_kl(m_all, raw_all))


def svgp_hetero_elbo(mean_kernel: Kernel, noise_kernel: Kernel, x, y, z, var_f: SVGPVariational,
                     var_g: SVGPVariational, jitter=None, data_scale: float = 1.0, point_weights=None,
                     noise_bias=0.0) -> torch.Tensor:
    """Variational heteroscedastic-GP bound (Lazaro-Gredilla & Titsias 2011,
    in SVGP form): y_i ~ N(f_i, exp(g_i)^2) with latent GPs f and g, the
    expected log-likelihood in closed form,

        E[log N(y; f, e^{2g})] = -log(2 pi)/2 - mu_g
            - ((y - mu_f)^2 + s_f^2) e^{-2 mu_g + 2 s_g^2} / 2,

    and ``noise_bias`` a scalar intercept of the log noise."""
    mu_f, s2_f = svgp_latent_moments(mean_kernel, x, z, var_f, jitter)
    mu_g, s2_g = svgp_latent_moments(noise_kernel, x, z, var_g, jitter)
    mu_g = mu_g + noise_bias
    y = torch.as_tensor(y, dtype=mu_f.dtype, device=mu_f.device)
    per_point = (-0.5 * math.log(2.0 * math.pi) - mu_g
                 - 0.5 * ((y - mu_f) ** 2 + s2_f) * torch.exp(-2.0 * mu_g + 2.0 * s2_g))
    if point_weights is not None:
        per_point = per_point * point_weights
    return data_scale * torch.sum(per_point) - svgp_kl(var_f) - svgp_kl(var_g)


def svgp_elbo(kernel: Kernel, x, y, z, lik: LatentLikelihood, var: SVGPVariational, jitter=None,
              num_quad_points: int = 20, data_scale: float = 1.0) -> torch.Tensor:
    """The SVGP evidence lower bound (Hensman et al. 2015 eq. 4).
    ``data_scale`` multiplies the expected log-likelihood (n_total / batch
    for an unbiased minibatch estimate); the KL is never scaled."""
    ell = svgp_expected_loglik(kernel, x, y, z, lik, var, jitter, num_quad_points)
    return data_scale * ell - svgp_kl(var)
