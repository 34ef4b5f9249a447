"""The port's convergence diagnostics against the JAX package's, on chains
with known autocorrelation (AR(1) processes), at rtol 1e-12; tensors and
numpy arrays give the same answers."""

import numpy as np
import pytest
import torch

from bayesianinference_tpu.results import diagnostics as jdiag
from bayesianinference_tpu_torch.results import diagnostics as tdiag


def _ar1(phi, m, n, d, seed):
    """m chains of an AR(1) process with coefficient phi per coordinate:
    lag-k autocorrelation phi^k, integrated time (1 + phi) / (1 - phi)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((m, n, d))
    x[:, 0] = rng.normal(size=(m, d)) / np.sqrt(1 - phi**2)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + rng.normal(size=(m, d))
    return x


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_autocorrelation_and_ess_match_jax(phi):
    x = _ar1(phi, 4, 2000, 3, seed=int(phi * 10))
    close(tdiag.autocorrelation(x[0], max_lag=50), jdiag.autocorrelation(x[0], max_lag=50))
    close(tdiag.autocorrelation(torch.tensor(x[1, :, 0])), jdiag.autocorrelation(x[1, :, 0]))
    np.testing.assert_allclose(tdiag.autocorrelation(x[0], max_lag=3)[:, 0], phi ** np.arange(4), atol=0.1)
    for split in (True, False):
        close(tdiag.effective_sample_size(torch.tensor(x), split=split), jdiag.effective_sample_size(x, split=split))
        close(tdiag.effective_sample_size(x[..., 0], split=split), jdiag.effective_sample_size(x[..., 0], split=split))
    ess = tdiag.effective_sample_size(x)
    want = x.shape[0] * x.shape[1] * (1 - phi) / (1 + phi)
    np.testing.assert_allclose(ess, want, rtol=0.3)


def test_gelman_rubin_matches_jax():
    x = _ar1(0.7, 6, 800, 2, seed=3)
    x[5] += 2.0  # one chain off: R-hat well above 1
    for split in (True, False):
        close(tdiag.gelman_rubin(torch.tensor(x), split=split), jdiag.gelman_rubin(x, split=split))
        close(tdiag.gelman_rubin(x[:5, :, 0], split=split), jdiag.gelman_rubin(x[:5, :, 0], split=split))
    assert (tdiag.gelman_rubin(x) > 1.1).all() and float(tdiag.gelman_rubin(x[:5, :, 0])) < 1.02
    const = np.ones((3, 10))
    assert float(tdiag.gelman_rubin(const)) == float(jdiag.gelman_rubin(const)) == 1.0
    with pytest.raises(ValueError, match="2 chains"):
        tdiag.gelman_rubin(x[:1, :, 0], split=False)


def test_weighted_effective_sample_size_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.gamma(0.5, size=500)
    close(tdiag.weighted_effective_sample_size(torch.tensor(w)), jdiag.weighted_effective_sample_size(w))
    lw = np.log(w)
    lw[:3] = -np.inf
    close(tdiag.weighted_effective_sample_size(lw, log=True), jdiag.weighted_effective_sample_size(lw, log=True))
    assert tdiag.weighted_effective_sample_size(np.ones(7)) == 7.0
    with pytest.raises(ValueError, match="nonnegative"):
        tdiag.weighted_effective_sample_size(-w)
