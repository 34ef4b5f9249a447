"""Parity of the port's adaptive-Metropolis chains with the JAX package.

``am_block`` is fed the JAX package's own draws, regenerated from each
chain's key exactly as ``ops/metropolis.py::am_block`` splits it, so the
two implementations walk the same chains: the results must agree to
atol 1e-10 (float64; only the summation order of the small products
differs).  The adaptive retry loop and the chain moments are checked
against their definitions and the closed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.core.numerics import log_zero as j_log_zero
from bayesianinference_tpu.ops import metropolis as jmet
from bayesianinference_tpu_torch.interop import am_state_from_numpy
from bayesianinference_tpu_torch.ops import metropolis as tmet

torch.set_num_threads(1)

MU = np.array([0.5, -1.0, 2.0])
SIG = np.array([1.0, 0.5, 2.0])
BOX = 4.0


def j_density(x):
    inside = jnp.all(jnp.abs(x - MU) < BOX * SIG)
    lp = -0.5 * jnp.sum(((x - MU) / SIG) ** 2)
    return jnp.where(inside, lp, j_log_zero(x.dtype))


def t_density(x):
    mu, sig = torch.as_tensor(MU), torch.as_tensor(SIG)
    inside = ((x - mu).abs() < BOX * sig).all(dim=-1)
    lp = -0.5 * (((x - mu) / sig) ** 2).sum(dim=-1)
    return torch.where(inside, lp, torch.full_like(lp, -1e300))


def _jax_states(c, t0, seed):
    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(MU + SIG * rng.normal(size=(c, 3)))
    cov0 = jnp.asarray(np.diag(SIG**2) * 0.3)
    mean0 = jnp.asarray(MU + 0.1)
    return jax.vmap(lambda x: jmet.am_init(x, j_density, mean0=mean0, cov0=cov0, t0=t0))(x0)


@pytest.mark.parametrize("t0,learn_delay", [(2, 5), (10, 10)])
def test_am_block_matches_jax_on_jax_draws(t0, learn_delay):
    c, j, d = 8, 25, 3
    jstate = _jax_states(c, t0, seed=t0)
    keys = jax.random.split(jax.random.PRNGKey(7 + t0), c)
    jout = jax.vmap(lambda k, s: jmet.am_block(k, s, j_density, j, learn_delay))(keys, jstate)

    # regenerate the block's draws from each key as metropolis.py:364-378 does
    zs, lus = [], []
    for key in keys:
        kz1, kacc = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(kz1, (d, j), jnp.float64)))
        lus.append(np.log(np.asarray(
            jax.random.uniform(kacc, (j,), jnp.float64, minval=1e-38, maxval=1.0))))
    tstate = am_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                                 device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(tstate.chol.numpy(), np.asarray(jstate.chol), atol=1e-12)
    tout = tmet.am_block(tstate, t_density, torch.as_tensor(np.stack(zs)),
                         torch.as_tensor(np.stack(lus)), learn_delay)
    for f in ("x", "mean", "chol", "log_density"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), atol=1e-10)
    for f in ("step", "accepted", "proposed"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)))
    assert 0 < int(tout.accepted.sum()) < c * j  # both accept and reject happened


def test_proposal_chol_and_small_cholesky_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 4, 4))
    spd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(4)
    spd[2] = -np.eye(4)  # non-PD element: diagonal fallback for that one only
    np.testing.assert_allclose(
        tmet.proposal_chol(torch.as_tensor(spd)).numpy(),
        np.asarray(jmet.proposal_chol(jnp.asarray(spd))), atol=1e-12)
    asym = spd[0] + 1e-3 * rng.normal(size=(4, 4))
    np.testing.assert_allclose(
        tmet.small_cholesky(torch.as_tensor(asym)).numpy(),
        np.asarray(jmet.small_cholesky(jnp.asarray(asym))), atol=1e-12)
    bad = tmet.small_cholesky(torch.as_tensor(-np.eye(3)))
    assert torch.isnan(bad).all()


def test_run_chain_adaptive_retries_until_bounds():
    """Chains whose recent-block acceptance lies outside the bounds get
    extra blocks until it lies inside or max_steps is reached; a chain
    that stopped is frozen."""
    c, d = 64, 3
    gen = torch.Generator().manual_seed(0)
    x0 = torch.as_tensor(MU).expand(c, d).clone()
    st = tmet.am_init(x0, t_density, cov0=torch.eye(d, dtype=torch.float64) * 9.0, t0=0)
    num, extra, max_steps = 10, 10, 50
    lo, hi = 0.35, 0.9
    out, acc = tmet.run_chain_adaptive(gen, st, t_density, num, extra, max_steps,
                                       min_acceptance=lo, max_acceptance=hi, learn_delay=1000)
    proposed = out.proposed.numpy()
    assert set(np.unique(proposed)) <= {10, 20, 30, 40, 50}
    assert (proposed > num).any() and (proposed == num).any()
    np.testing.assert_allclose(acc.numpy(), out.accepted.numpy() / proposed, rtol=1e-15)
    # a chain that stopped after its first block had its rate within bounds
    first_only = proposed == num
    assert ((acc.numpy()[first_only] >= lo) & (acc.numpy()[first_only] <= hi)).all()
    assert (out.step.numpy() == proposed).all()

    # trivial bounds: no retries at all
    out2, _ = tmet.run_chain_adaptive(gen, st, t_density, num, extra, max_steps)
    assert (out2.proposed.numpy() == num).all()


def test_chain_moments_match_gaussian():
    """2000 independent chains, 400 steps in blocks of 50 with adaptation:
    the final states' mean and covariance match the target's (a correlated
    2-D Gaussian) within sampling error, and so does the chains' adapted
    covariance."""
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    mean = torch.tensor([1.0, -2.0], dtype=torch.float64)

    def density(x):
        z = x - mean
        return -0.5 * torch.einsum("ci,ij,cj->c", z, prec, z)

    c = 2000
    gen = torch.Generator().manual_seed(1)
    x0 = mean + torch.randn((c, 2), generator=gen, dtype=torch.float64) * 3.0
    st = tmet.am_init(x0, density, t0=0)
    st = tmet.run_chain(gen, st, density, 400, learn_delay=20, block_size=50)
    x = st.x.numpy()
    np.testing.assert_allclose(x.mean(axis=0), mean.numpy(), atol=0.12)  # ~5 standard errors
    np.testing.assert_allclose(np.cov(x.T), cov, rtol=0.15, atol=0.1)
    np.testing.assert_allclose(st.cov.mean(dim=0).numpy(), cov, rtol=0.2, atol=0.15)
    rate = (st.accepted.double() / st.proposed.double()).mean().item()
    assert 0.2 < rate < 0.9
