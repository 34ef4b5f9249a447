"""Sparse variational GP regression: Titsias' collapsed SGPR bound (port of
``bayesianinference_tpu.ops.sgpr``).

The collapsed variational bound (Titsias 2009, AISTATS) replaces the n x n
factorization of the GP logML with m << n inducing points:

    logML >= log N(y | 0, Q_nn + sigma^2 I) - tr(K_nn - Q_nn)/(2 sigma^2),
    Q_nn = K_nm K_mm^-1 K_mn,

with one m x m Cholesky of K_mm, one of B = I + A A^T and [m, n] matmuls,
A = L^-1 K_mn / sigma whitened before the Gram product (forming K_mn K_nm
first squares the condition number of the kernel matrix).  K_mn is one
rectangular call of the SE op ([m, n], the hand-written kernel on the
card), both Cholesky factors go through the ``cholesky`` op.  Failed
factorizations give the finite per-dtype log-zero sentinel.  With z = x
the bound equals the dense logML.

Not ported, as TPU workarounds: ``_tri_inv_lower`` behind
``_safe_chol_inv`` (a blocked divide-and-conquer triangular inverse that
keeps the TPU's matrix unit busy; here ``torch.linalg.solve_triangular``
against the identity) and ``_HI = Precision.HIGHEST`` (the TPU's matmul
precision flag: TF32 stays off on the card, PyTorch's default).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import LOG2PI, as_float, log_zero
from .gp_kernels import Kernel, cholesky

__all__ = ["SGPRState", "sgpr_kuu_inv_chol", "sgpr_data_stats", "sgpr_state_from_stats", "sgpr_state",
           "sgpr_bound", "sgpr_predict"]


class SGPRState(NamedTuple):
    """Sufficient posterior state of a collapsed SGPR fit, sized [m] / [m, m].

    ``linv``/``lb_inv`` are the inverse Cholesky factors of K_mm and
    B = I + A A^T; ``c`` is LB^-1 A err / sigma; ``ok`` flags a successful
    factorization."""

    linv: torch.Tensor  # [m, m]  L^-1, L = chol(K_mm)
    lb_inv: torch.Tensor  # [m, m]  LB^-1, LB = chol(I + A A^T)
    c: torch.Tensor  # [m]     LB^-1 A err / sigma
    bound: torch.Tensor  # scalar  collapsed ELBO (lower bound on logML)
    ok: torch.Tensor  # scalar bool


def _safe_chol_inv(mat: torch.Tensor):
    """(L^-1, diag L, ok) of a symmetric PD matrix; a failed factorization
    yields the identity's and ok False."""
    m = mat.shape[-1]
    eye = torch.eye(m, dtype=mat.dtype, device=mat.device)
    factor = cholesky(mat)
    diag = torch.diagonal(factor, dim1=-2, dim2=-1)
    ok = torch.isfinite(diag).all(dim=-1)
    safe = torch.where(ok[..., None, None], factor, eye)
    return torch.linalg.solve_triangular(safe, eye, upper=False), torch.diagonal(safe, dim1=-2, dim2=-1), ok


def sgpr_kuu_inv_chol(kernel: Kernel, z, jitter: Optional[float] = None):
    """(L^-1, ok) of the jittered inducing covariance K_mm = L L^T.
    ``jitter`` (relative to the mean diagonal) defaults per dtype: 1e-6 in
    float32, 1e-12 in float64."""
    z = torch.atleast_2d(as_float(z))
    dtype = z.dtype
    m = z.shape[0]
    kuu = kernel.matrix(z, z)
    kuu = 0.5 * (kuu + kuu.mT)
    if jitter is None:
        jitter = 1e-12 if dtype == torch.float64 else 1e-6
    eps = jitter * torch.mean(torch.diagonal(kuu))
    linv, _, ok = _safe_chol_inv(kuu + eps * torch.eye(m, dtype=dtype, device=z.device))
    return linv, ok


def sgpr_data_stats(kernel: Kernel, linv, z, x, err, sig2, weights=None):
    """Sufficient statistics of the collapsed bound, ``(aat, ay, yy,
    kdiag_sum, n)`` with A = L^-1 K_mn / sigma; every field sums over the
    data axis.  ``weights``: an optional [n] 0/1 mask zeroing rows in every
    statistic."""
    kuf = kernel.matrix(torch.atleast_2d(as_float(z)), x)  # [m, n]
    a = (linv @ kuf) / torch.sqrt(sig2)
    kdiag = kernel.diag(x)
    if weights is not None:
        a = a * weights[None, :]
        err = err * weights
        kdiag = kdiag * weights
        n = torch.sum(weights)
    else:
        n = err.shape[0]
    return a @ a.mT, a @ err, torch.dot(err, err), torch.sum(kdiag), n


def sgpr_state_from_stats(linv, ok_l, stats, noise_variance) -> SGPRState:
    """Finish the collapsed fit from the data statistics: the [m, m]
    Cholesky of B = I + A A^T, the predictive vector c and the bound."""
    aat, ay, yy, kdiag_sum, n = stats
    dtype = aat.dtype
    m = aat.shape[-1]
    sig2 = torch.as_tensor(noise_variance, dtype=dtype, device=aat.device)
    b = torch.eye(m, dtype=dtype, device=aat.device) + 0.5 * (aat + aat.mT)
    lb_inv, lb_diag, ok_b = _safe_chol_inv(b)
    ok = ok_l & ok_b & (sig2 > 0)
    c = (lb_inv @ ay) / torch.sqrt(sig2)  # LB^-1 A err / sigma
    n_f = torch.as_tensor(n, dtype=dtype, device=aat.device)
    bound = (
        -0.5 * n_f * (LOG2PI + torch.log(sig2))
        - torch.sum(torch.log(lb_diag))  # -0.5 log det B
        - 0.5 * yy / sig2
        + 0.5 * torch.dot(c, c)  # |LB^-1 A err|^2 / (2 sigma^2)
        - 0.5 * kdiag_sum / sig2
        + 0.5 * torch.trace(aat)
    )
    bound = torch.where(ok & torch.isfinite(bound), bound, torch.full_like(bound, log_zero(dtype)))
    return SGPRState(linv=linv, lb_inv=lb_inv, c=c, bound=bound, ok=ok)


def sgpr_state(kernel: Kernel, x, y, z, noise_variance, *, mean_fn: Optional[Callable] = None,
               jitter: Optional[float] = None) -> SGPRState:
    """Factorize the collapsed SGPR posterior and evaluate its bound.
    ``z``: [m, d] inducing inputs; ``noise_variance``: scalar sigma^2."""
    x, y = as_float(x), as_float(y)
    sig2 = torch.as_tensor(noise_variance, dtype=y.dtype, device=y.device)
    err = y - (mean_fn(x) if mean_fn is not None else 0.0)
    linv, ok_l = sgpr_kuu_inv_chol(kernel, z, jitter)
    stats = sgpr_data_stats(kernel, linv, z, x, err, sig2)
    return sgpr_state_from_stats(linv, ok_l, stats, sig2)


def sgpr_bound(kernel: Kernel, x, y, z, noise_variance, *, mean_fn: Optional[Callable] = None,
               jitter: Optional[float] = None) -> torch.Tensor:
    """Collapsed SGPR evidence lower bound (Titsias 2009 eq. 9): exact
    (= dense logML) at ``z = x``, a lower bound for m < n."""
    return sgpr_state(kernel, x, y, z, noise_variance, mean_fn=mean_fn, jitter=jitter).bound


def sgpr_predict(kernel: Kernel, state: SGPRState, z, x_query, noise_variance=None, *,
                 mean_fn: Optional[Callable] = None):
    """Posterior predictive moments at query points: with V = L^-1 K_m*,
    W = LB^-1 V,  m* = W^T c,  s*^2 = k** - |V|^2_col + |W|^2_col (+ sigma^2).
    Returns (mean [p], std [p])."""
    z, xq = torch.atleast_2d(as_float(z)), torch.atleast_2d(as_float(x_query))
    kus = kernel.matrix(z, xq)  # [m, p]
    v = state.linv @ kus
    w = state.lb_inv @ v
    mean = w.mT @ state.c
    if mean_fn is not None:
        mean = mean + mean_fn(xq)
    var = kernel.diag(xq) - (v * v).sum(dim=0) + (w * w).sum(dim=0)
    if noise_variance is not None:
        var = var + torch.as_tensor(noise_variance, dtype=var.dtype, device=var.device)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
