"""Nested-sampling bookkeeping math (port of ``bayesianinference_tpu.ops.ns_math``).

With ``k`` worst points deleted per iteration from ``n`` live points, the
i-th deletion happens with ``m_i = n - ((i - 1) mod k)`` points above the
threshold, so its crude shrinkage is ``E[-log t_i] = 1 / m_i``.
"""

from __future__ import annotations

import math

import torch

from ..core.numerics import log_zero, logaddexp, logsubexp

__all__ = [
    "pool_schedule",
    "crude_log_x_deleted",
    "log_x_live_tail",
    "log_trapezoid_weights",
    "entropy_from_weights",
]

_LOG2 = math.log(2.0)
_LOG_HALF = math.log(0.5)


def pool_schedule(n_live: int, num_delete: int, capacity: int, *, dtype=None, device=None) -> torch.Tensor:
    """[capacity] effective pool sizes m_i of the i-th deletion."""
    i = torch.arange(capacity, device=device)
    return (n_live - (i % num_delete)).to(dtype or torch.get_default_dtype())


def crude_log_x_deleted(schedule: torch.Tensor) -> torch.Tensor:
    """logX_i = -sum_{j <= i} 1 / m_j for the deleted points."""
    return -torch.cumsum(1.0 / schedule, dim=-1)


def log_x_live_tail(n_live: int, log_x_last_deleted, *, dtype=None, device=None) -> torch.Tensor:
    """logX of the n final live points, descending:
    log(i / (n + 1)) + logX_deleted for i = n..1."""
    i = torch.arange(n_live, 0, -1, dtype=dtype or torch.get_default_dtype(), device=device)
    return torch.log(i / (n_live + 1.0)) + log_x_last_deleted


def log_trapezoid_weights(log_x: torch.Tensor, valid=None) -> torch.Tensor:
    """Trapezoid log-weights of a descending logX sequence [..., m]:

      w_i = (X_{i-1} - X_{i+1}) / 2   with  X_0 := 2 - X_1
      w_m = (X_{m-1} + X_m) / 2       (last point)

    With ``valid`` (a boolean contiguous-prefix mask [..., m]) the weights
    are computed as if the valid prefix were the whole sequence; invalid
    slots get log-zero."""
    lz = log_zero(log_x.dtype)
    prev = torch.cat([logsubexp(_LOG2, log_x[..., :1]), log_x[..., :-1]], dim=-1)
    nxt = torch.cat([log_x[..., 1:], torch.full_like(log_x[..., :1], lz)], dim=-1)
    mid = logsubexp(prev, nxt)
    if valid is None:
        w = torch.cat([mid[..., :-1], logaddexp(log_x[..., -2:-1], log_x[..., -1:])], dim=-1)
        return w + _LOG_HALF
    valid = torch.as_tensor(valid, device=log_x.device)
    count = valid.sum(dim=-1)
    idx = torch.arange(log_x.shape[-1], device=log_x.device)
    is_last = idx == (count - 1).unsqueeze(-1)
    w = torch.where(is_last, logaddexp(prev, log_x), mid)
    return torch.where(valid, w + _LOG_HALF, torch.full_like(w, lz))


def entropy_from_weights(log_weights, log_likelihoods, log_evidence) -> torch.Tensor:
    """H = sum_i exp(logw_i - logZ) * logL_i - logZ, where logw already
    includes logL; log-zero likelihoods contribute 0."""
    lw = torch.as_tensor(log_weights)
    ll = torch.as_tensor(log_likelihoods)
    lz = log_zero(lw.dtype)
    safe_ll = torch.where(ll > 0.5 * lz, ll, torch.zeros_like(ll))
    log_evidence = torch.as_tensor(log_evidence, dtype=lw.dtype, device=lw.device)
    return torch.sum(torch.exp(lw - log_evidence.unsqueeze(-1)) * safe_ll, dim=-1) - log_evidence
