"""Chain and weighted-sample convergence diagnostics (port of
``bayesianinference_tpu.results.diagnostics``, which is numpy-only; the
port keeps its own copy).

FFT autocorrelation, Geyer initial-monotone-sequence effective sample
size, split Gelman-Rubin R-hat, and Kish's effective sample size of an
importance-weighted sample.  Host-side numpy post-processing, run once per
fit: Geyer's data-dependent truncation is a host loop.  The functions take
numpy arrays or tensors on any device (copied to the host in float64).

Shapes: ``chains`` is [n_chains, n_samples] (scalar parameter) or
[n_chains, n_samples, d]; a 1-D input is promoted to one scalar chain.
A single d-parameter chain must be passed as [1, n_samples, d].  Outputs
are scalar for scalar parameters, [d] otherwise.  ``HMCResult`` and
``EnsembleResult`` give [chains, samples] through ``per_parameter_chains``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "gelman_rubin",
    "weighted_effective_sample_size",
]


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _to_cnd(chains) -> np.ndarray:
    """Canonicalize to [n_chains, n_samples, d] float64."""
    x = _host(chains)
    if x.ndim == 1:
        x = x[None, :, None]
    elif x.ndim == 2:
        x = x[:, :, None]  # [m, n] -> [m, n, 1]
    elif x.ndim != 3:
        raise ValueError(f"chains must be 1-, 2- or 3-D, got shape {x.shape}")
    return x


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance (normalized by n) along axis 1 of [m, n, d]
    via FFT — O(n log n) instead of the O(n^2) direct sum."""
    m, n, d = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    size = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    return acov / n


def autocorrelation(chain, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation function of a SINGLE chain
    [n_samples] or [n_samples, d].

    Returns [max_lag + 1(, d)] with lag 0 equal to 1 (constant chains
    return 1 at lag 0 and 0 beyond, rather than NaN).
    """
    x = _host(chain)
    squeeze = x.ndim == 1
    if x.ndim not in (1, 2):
        raise ValueError(f"chain must be 1- or 2-D, got shape {x.shape}")
    x = x.reshape(1, x.shape[0], -1)  # [1, n, d]
    n = x.shape[1]
    if max_lag is None:
        max_lag = n - 1
    max_lag = min(max_lag, n - 1)
    acov = _autocov_fft(x)[0, : max_lag + 1]  # [L, d]
    var = acov[0]
    safe = np.where(var > 0, var, 1.0)
    rho = np.where(var > 0, acov / safe, 0.0)
    rho[0] = 1.0
    return rho[:, 0] if squeeze else rho


def _split(x: np.ndarray) -> np.ndarray:
    """Split each chain in half (Stan-style split diagnostics): [m, n, d]
    -> [2m, n//2, d].  Odd lengths drop the middle sample."""
    m, n, d = x.shape
    h = n // 2
    return np.concatenate([x[:, :h], x[:, n - h :]], axis=0)


def effective_sample_size(chains, split: bool = True) -> np.ndarray:
    """Effective sample size via Geyer's initial monotone sequence
    estimator over the chain-averaged autocorrelation (the Stan/ArviZ
    ``ess_bulk`` construction on raw values).

    ``split=True`` halves each chain first so within-chain drift counts
    against the estimate.  Requires at least 4 samples per (split) chain.
    """
    chains = _host(chains)
    x = _split(_to_cnd(chains)) if split else _to_cnd(chains)
    m, n, d = x.shape
    if n < 4:
        raise ValueError("need at least 4 samples per split chain")
    acov = _autocov_fft(x)  # [m, n, d], biased (normalized by n)
    # within-chain variance (ddof=1) and the pooled posterior variance
    # var_plus = (n-1)/n W + B/n; the biased acov0 mean IS (n-1)/n W
    w = (acov[:, 0] * n / (n - 1.0)).mean(axis=0)  # [d]
    var_plus = acov[:, 0].mean(axis=0) + (
        np.var(x.mean(axis=1), axis=0, ddof=1) if m > 1 else 0.0
    )
    mean_acov = acov.mean(axis=0)  # [d] per lag
    out = np.empty(d)
    for j in range(d):
        if var_plus[j] <= 0:
            # constant/degenerate chains: a sampler stuck at one point has
            # no effective samples — flag with NaN (ArviZ convention)
            # rather than report m*n "perfect mixing"
            out[j] = np.nan
            continue
        rho = 1.0 - (w[j] - mean_acov[:, j]) / var_plus[j]  # [n]
        # Geyer: sums of adjacent pairs P_t = rho_{2t} + rho_{2t+1} are
        # positive and decreasing for a reversible chain; truncate at the
        # first negative pair and enforce monotonicity.
        n_pairs = (len(rho) - 1) // 2
        prev = np.inf
        s = 0.0
        for t in range(n_pairs):
            p = rho[2 * t] + rho[2 * t + 1]
            if p <= 0:
                break
            p = min(p, prev)
            prev = p
            s += p
        tau = max(-1.0 + 2.0 * s, 1.0 / (m * n))
        out[j] = m * n / tau
    return out[0] if d == 1 and chains.ndim <= 2 else out


def gelman_rubin(chains, split: bool = True) -> np.ndarray:
    """Split potential-scale-reduction factor R-hat:
    sqrt(((n-1)/n W + B/n) / W) over (split) chains.  Values near 1
    indicate the chains agree; > ~1.01-1.1 indicates non-convergence.
    Requires at least 2 (split) chains and 2 samples each."""
    chains = _host(chains)
    x = _split(_to_cnd(chains)) if split else _to_cnd(chains)
    m, n, d = x.shape
    if m < 2:
        raise ValueError(
            "R-hat needs >= 2 chains (or >= 1 chain with split=True)"
        )
    if n < 2:
        raise ValueError("need at least 2 samples per split chain")
    means = x.mean(axis=1)  # [m, d]
    w = x.var(axis=1, ddof=1).mean(axis=0)  # [d]
    b_over_n = means.var(axis=0, ddof=1)  # [d] (= B / n)
    safe_w = np.where(w > 0, w, 1.0)
    var_plus = (n - 1.0) / n * w + b_over_n
    # W = 0 with disagreeing chains (each stuck at its own constant) is
    # the R-hat -> infinity limit, NOT convergence; only W = B = 0
    # (identical constant chains) legitimately reports 1.
    rhat = np.where(
        w > 0,
        np.sqrt(var_plus / safe_w),
        np.where(b_over_n > 0, np.inf, 1.0),
    )
    return rhat[0] if d == 1 and chains.ndim <= 2 else rhat


def weighted_effective_sample_size(weights, log: bool = False) -> float:
    """Kish effective sample size of an importance-weighted sample:
    (sum w)^2 / sum w^2.  Pass ``log=True`` for log-weights (e.g. a
    nested-sampling result's ``crude_log_posterior_weights``), evaluated
    stably via logsumexp shifts.  Between 1 (one sample carries all mass)
    and n (uniform weights)."""
    w = _host(weights).ravel()
    if log:
        finite = w[np.isfinite(w)]
        if finite.size == 0:
            return 0.0
        shift = finite.max()
        lse1 = shift + np.log(np.sum(np.exp(finite - shift)))
        lse2 = 2.0 * shift + np.log(np.sum(np.exp(2.0 * (finite - shift))))
        return float(np.exp(2.0 * lse1 - lse2))
    if np.any(w < 0):
        raise ValueError("weights must be nonnegative")
    total = w.sum()
    if total == 0:
        return 0.0
    return float(total**2 / np.sum(w**2))
