"""Exponential-family abstraction: natural parameters, log-partition,
conjugate updating and predictive densities (port of
``bayesianinference_tpu.dists.expfam``).

A family is described by callables; the canonical density is
h(x) exp(eta . T(x) - A(eta)) and the conjugate prior over eta is
exp(eta . chi - nu A(eta) - B(chi, nu)) with B = log_conjugate_partition.
The posterior update is (chi, nu) -> (chi + sum_i T(x_i), nu + n) and the
predictive density the partition ratio at (chi + T(x), nu + 1).  Plain
functions on tensors: they follow the dtype and device of their inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..core.numerics import LOG2PI, as_float

__all__ = [
    "ExponentialFamily",
    "EXPONENTIAL",
    "NORMAL",
    "POISSON",
    "LOG_NORMAL",
    "GAMMA",
    "INVERSE_GAMMA",
    "GAMMA_FIXED_SHAPE",
    "conjugate_update",
    "bind_gamma_shape",
]


def _f(x) -> torch.Tensor:
    return as_float(x)


def _stack(*cols) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def _nu_like(nu, ref: torch.Tensor) -> torch.Tensor:
    """``nu`` as a tensor beside ``ref`` (in its dtype when a number)."""
    if isinstance(nu, torch.Tensor):
        return nu.to(device=ref.device)
    return torch.full((), float(nu), dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class ExponentialFamily:
    """An exponential family in natural coordinates."""

    name: str
    natural_parameters: Callable  # standard parameters -> eta [k]
    log_partition: Callable  # eta [k] -> A(eta)
    log_base_measure: Callable  # x -> log h(x)
    sufficient_statistic: Callable  # x -> T(x) [k]
    natural_parameter_count: int
    # B(chi, nu): normalizer of the conjugate prior; None if not closed-form
    log_conjugate_partition: Optional[Callable] = None
    # eta -> bool: the natural-parameter region where A(eta) is finite
    # (None: all of R^k)
    natural_parameter_support: Optional[Callable] = None
    # the standard-parameter region
    parameter_support: Optional[Callable] = None

    def log_pdf(self, x, eta):
        """Canonical log-density h(x) exp(eta . T(x) - A(eta))."""
        t = self.sufficient_statistic(x)
        eta = _f(eta)
        return self.log_base_measure(x) + torch.sum(eta * t, dim=-1) - self.log_partition(eta)

    def log_conjugate_kernel(self, eta, chi, nu):
        """log of exp(eta . chi - nu A(eta))."""
        eta, chi = _f(eta), _f(chi)
        return torch.sum(eta * chi, dim=-1) - _nu_like(nu, eta) * self.log_partition(eta)

    def log_conjugate_pdf(self, eta, chi, nu):
        """The normalized conjugate-prior log-density."""
        if self.log_conjugate_partition is None:
            raise NotImplementedError(f"no closed-form conjugate partition for {self.name}")
        return self.log_conjugate_kernel(eta, chi, nu) - self.log_conjugate_partition(chi, nu)

    def log_predictive_pdf(self, x, chi, nu):
        """The posterior-predictive log-density as a ratio of partitions."""
        if self.log_conjugate_partition is None:
            raise NotImplementedError(f"no closed-form conjugate partition for {self.name}")
        t = self.sufficient_statistic(x)
        chi = _f(chi).to(t.device)
        nu = _nu_like(nu, chi)
        return (self.log_base_measure(x) + self.log_conjugate_partition(chi + t, nu + 1.0)
                - self.log_conjugate_partition(chi, nu))


def conjugate_update(family: ExponentialFamily, chi, nu, data):
    """(chi, nu) -> (chi + sum T(x_i), nu + n): the conjugate posterior update."""
    t = torch.atleast_2d(family.sufficient_statistic(_f(data)))  # [n, k]
    chi = _f(chi).to(t.device)
    return chi + torch.sum(t, dim=0), _nu_like(nu, chi) + t.shape[0]


# ---------------------------------------------------------------------------
# Instances
# ---------------------------------------------------------------------------

EXPONENTIAL = ExponentialFamily(
    name="Exponential",
    # eta = -lambda
    natural_parameters=lambda lam: _stack(-_f(lam)),
    log_partition=lambda eta: -torch.log(-_f(eta)[..., 0]),
    log_base_measure=lambda x: torch.zeros_like(_f(x)),
    sufficient_statistic=lambda x: _stack(_f(x)),
    natural_parameter_count=1,
    natural_parameter_support=lambda eta: _f(eta)[..., 0] < 0,
    parameter_support=lambda lam: _f(lam) > 0,
    # int exp(eta chi + nu log(-eta)) d eta over eta < 0 = Gamma(nu + 1) / chi^(nu + 1)
    log_conjugate_partition=lambda chi, nu: torch.lgamma(_nu_like(nu, _f(chi)) + 1.0)
    - (_nu_like(nu, _f(chi)) + 1.0) * torch.log(_f(chi)[..., 0]),
)


def _normal_nat(mu, var):
    mu, var = _f(mu), _f(var)
    return _stack(mu / var, -0.5 / var)


def _normal_logpart(eta):
    eta = _f(eta)
    e1, e2 = eta[..., 0], eta[..., 1]
    return -(e1 * e1) / (4.0 * e2) - 0.5 * torch.log(-2.0 * e2)


def _nig_log_partition(chi, nu):
    """Normalizer of the Normal conjugate prior in natural coordinates (the
    normal-inverse-gamma normalizer):

      B(chi, nu) = int exp(eta . chi - nu A(eta)) d eta
                 = sqrt(2 pi / nu) / 2 * Gamma(a) / b^a

    with a = nu/2 + 3/2 and b = (chi2 - chi1^2 / nu) / 2 (eta1 = mu/v,
    eta2 = -1/(2v), Jacobian 1/(2 v^3), a Gaussian integral over mu and a
    Gamma integral over v).  Requires chi2 > chi1^2 / nu, which chi
    accumulated from real data always meets."""
    chi = _f(chi)
    c1, c2 = chi[..., 0], chi[..., 1]
    nu = _nu_like(nu, chi)
    a = 0.5 * nu + 1.5
    b = 0.5 * (c2 - c1 * c1 / nu)
    return 0.5 * torch.log(2.0 * math.pi / nu) - math.log(2.0) + torch.lgamma(a) - a * torch.log(b)


NORMAL = ExponentialFamily(
    name="Normal",
    natural_parameters=lambda mu, var: _normal_nat(mu, var),
    log_partition=_normal_logpart,
    log_base_measure=lambda x: torch.full(_f(x).shape, -0.5 * LOG2PI, dtype=_f(x).dtype, device=_f(x).device),
    sufficient_statistic=lambda x: _stack(_f(x), _f(x) ** 2),
    natural_parameter_count=2,
    log_conjugate_partition=_nig_log_partition,
    natural_parameter_support=lambda eta: _f(eta)[..., 1] < 0,
    parameter_support=lambda mu, var: _f(var) > 0,
)

POISSON = ExponentialFamily(
    name="Poisson",
    # eta = log lambda
    natural_parameters=lambda lam: _stack(torch.log(_f(lam))),
    log_partition=lambda eta: torch.exp(_f(eta)[..., 0]),
    log_base_measure=lambda x: -torch.lgamma(_f(x) + 1.0),
    sufficient_statistic=lambda x: _stack(_f(x)),
    natural_parameter_count=1,
    # int exp(eta chi - nu e^eta) d eta = Gamma(chi) / nu^chi
    log_conjugate_partition=lambda chi, nu: torch.lgamma(_f(chi)[..., 0])
    - _f(chi)[..., 0] * torch.log(_nu_like(nu, _f(chi))),
    natural_parameter_support=lambda eta: torch.isfinite(_f(eta)[..., 0]),
    parameter_support=lambda lam: _f(lam) > 0,
)

LOG_NORMAL = ExponentialFamily(
    name="LogNormal",
    # the Normal family on log x with an extra 1/x base measure
    natural_parameters=lambda mu, var: _normal_nat(mu, var),
    log_partition=_normal_logpart,
    log_base_measure=lambda x: -0.5 * LOG2PI - torch.log(_f(x)),
    sufficient_statistic=lambda x: _stack(torch.log(_f(x)), torch.log(_f(x)) ** 2),
    natural_parameter_count=2,
    log_conjugate_partition=_nig_log_partition,
)

GAMMA = ExponentialFamily(
    name="Gamma",
    # Gamma with shape k and scale theta: eta = (k - 1, -1/theta),
    # T(x) = (log x, x), A = lgamma(eta1 + 1) - (eta1 + 1) log(-eta2), h = 1.
    # No closed-form conjugate partition: conjugate_update still accumulates
    # (chi, nu) exactly; the normalized conjugate and predictive densities raise.
    natural_parameters=lambda k, theta: _stack(_f(k) - 1.0, -1.0 / _f(theta)),
    log_partition=lambda eta: torch.lgamma(_f(eta)[..., 0] + 1.0)
    - (_f(eta)[..., 0] + 1.0) * torch.log(-_f(eta)[..., 1]),
    log_base_measure=lambda x: torch.zeros(_f(x).shape, dtype=_f(x).dtype, device=_f(x).device),
    sufficient_statistic=lambda x: _stack(torch.log(_f(x)), _f(x)),
    natural_parameter_count=2,
    natural_parameter_support=lambda eta: (_f(eta)[..., 0] > -1.0) & (_f(eta)[..., 1] < 0),
    parameter_support=lambda k, theta: (_f(k) > 0) & (_f(theta) > 0),
)

INVERSE_GAMMA = ExponentialFamily(
    name="InverseGamma",
    # eta = (-a - 1, -b), T(x) = (log x, 1/x),
    # A = lgamma(-eta1 - 1) - (-eta1 - 1) log(-eta2), h = 1; no closed-form
    # conjugate partition, as for Gamma
    natural_parameters=lambda a, b: _stack(-_f(a) - 1.0, -_f(b)),
    log_partition=lambda eta: torch.lgamma(-_f(eta)[..., 0] - 1.0)
    - (-_f(eta)[..., 0] - 1.0) * torch.log(-_f(eta)[..., 1]),
    log_base_measure=lambda x: torch.zeros(_f(x).shape, dtype=_f(x).dtype, device=_f(x).device),
    sufficient_statistic=lambda x: _stack(torch.log(_f(x)), 1.0 / _f(x)),
    natural_parameter_count=2,
    natural_parameter_support=lambda eta: (_f(eta)[..., 0] < -1.0) & (_f(eta)[..., 1] < 0),
    parameter_support=lambda a, b: (_f(a) > 0) & (_f(b) > 0),
)

GAMMA_FIXED_SHAPE = ExponentialFamily(
    name="GammaFixedShape",
    # Gamma with known shape alpha and unknown rate: eta = -beta, T = x,
    # A = -alpha log(-eta); its conjugate partition Gamma(alpha nu + 1) / chi^(.)
    natural_parameters=lambda alpha, beta: _stack(-_f(beta)),
    log_partition=None,  # set per alpha by bind_gamma_shape
    log_base_measure=None,
    sufficient_statistic=lambda x: _stack(_f(x)),
    natural_parameter_count=1,
)


def bind_gamma_shape(alpha) -> ExponentialFamily:
    """The fixed-shape Gamma family for a concrete ``alpha``."""
    alpha = _f(alpha)

    def a_like(ref):
        return alpha.to(dtype=ref.dtype, device=ref.device)

    return dataclasses.replace(
        GAMMA_FIXED_SHAPE,
        log_partition=lambda eta: -a_like(_f(eta)) * torch.log(-_f(eta)[..., 0]),
        log_base_measure=lambda x: (a_like(_f(x)) - 1.0) * torch.log(_f(x)) - torch.lgamma(a_like(_f(x))),
        log_conjugate_partition=lambda chi, nu: torch.lgamma(a_like(_f(chi)) * _nu_like(nu, _f(chi)) + 1.0)
        - (a_like(_f(chi)) * _nu_like(nu, _f(chi)) + 1.0) * torch.log(_f(chi)[..., 0]),
    )
