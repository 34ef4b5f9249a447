"""The port's public Markov-chain API against the JAX package, on the CPU in
float64: the slice block draw for draw on the JAX draws (rtol 1e-10), the
chain's construction exactly, and both chain kinds against the moments of
their targets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import mcmc as jmcmc
from bayesianinference_tpu.ops import metropolis as jmet
from bayesianinference_tpu_torch.dists.multivariate import MultivariateNormal
from bayesianinference_tpu_torch.engines import mcmc as tmcmc
from bayesianinference_tpu_torch.interop import am_state_from_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.slice import SliceDraws

torch.set_num_threads(1)
F64 = jnp.float64
COV = np.array([[1.0, 0.8], [0.8, 1.0]])
PREC = np.linalg.inv(COV)


def j_dens(x):
    return -0.5 * x @ jnp.asarray(PREC) @ x


def t_dens(x):  # per point, as the API takes it
    return -0.5 * x @ torch.as_tensor(PREC, dtype=x.dtype) @ x


def _slice_draws_of(key, d, max_shrink=32):
    k_dir, k_level, k_lo, _, k_shrink = jax.random.split(key, 5)
    us = []
    for _ in range(max_shrink):
        k_shrink, sub = jax.random.split(k_shrink)
        us.append(jax.random.uniform(sub, (), F64))
    return (jax.random.normal(k_dir, (d,), F64), jax.random.uniform(k_level, (), F64, minval=1e-12, maxval=1.0),
            jax.random.uniform(k_lo, (), F64), jnp.stack(us))


@pytest.mark.parametrize("t0,learn_delay", [(0, 20), (30, 20)])
def test_slice_block_matches_jax_on_jax_draws(t0, learn_delay, monkeypatch):
    """Before the learn delay the directions come from the identity, after it
    from each chain's own running factor; every visited point is absorbed by
    a rank-one update."""
    chains, d, num = 6, 2, 9
    rng = np.random.default_rng(t0)
    x0 = jnp.asarray(rng.normal(size=(chains, d)))
    jstate = jax.vmap(lambda x: jmet.am_init(x, j_dens, mean0=jnp.zeros(d), cov0=jnp.asarray(COV) * 0.7, t0=t0))(x0)
    keys = jax.random.split(jax.random.PRNGKey(t0 + 1), chains)
    jout = jax.vmap(lambda k, s: jmcmc._slice_block(k, s, j_dens, num, learn_delay))(keys, jstate)

    per_chain = jax.vmap(lambda k: jax.vmap(lambda ku: _slice_draws_of(ku, d))(jax.random.split(k, num)))(keys)
    stacked = [torch.tensor(np.swapaxes(np.asarray(a), 0, 1)) for a in per_chain]  # [num, C, ...]
    feed = iter(SliceDraws(*(a[s] for a in stacked)) for s in range(num))
    monkeypatch.setattr(tmcmc, "slice_draws", lambda *a, **k: next(feed))
    state = am_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                                device="cpu", dtype=torch.float64)
    out = tmcmc._slice_block(None, state, torch.func.vmap(t_dens), num, learn_delay)
    for f in ("x", "log_density", "mean", "chol"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)), rtol=1e-10, atol=1e-13)
    for f in ("step", "accepted", "proposed"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)))


@pytest.mark.parametrize("cov0", [1.0, 0.25, [0.5, 2.0], [[2.0, 0.3], [0.3, 1.0]]], ids=["one", "scalar", "diag", "full"])
def test_create_chain_matches_jax(cov0):
    x0 = np.array([0.3, -0.4])
    jchain = jmcmc.create_mcmc_chain(j_dens, jnp.asarray(x0), initial_covariance=cov0, covariance_learn_delay=7)
    chain = tmcmc.create_mcmc_chain(t_dens, torch.tensor(x0), initial_covariance=cov0, covariance_learn_delay=7)
    assert chain.single and chain.method == "adaptive_metropolis" and chain.covariance_learn_delay == 7
    for f in ("x", "log_density", "mean", "chol"):
        np.testing.assert_allclose(getattr(chain.state, f)[0].numpy(), np.asarray(getattr(jchain.state, f)), rtol=1e-12)
    assert int(chain.state.step[0]) == 0 and float(chain.acceptance_rate) == 0.0


def test_invalid_method_and_default_device():
    with pytest.raises(ValueError, match="unknown method"):
        tmcmc.create_mcmc_chain(t_dens, torch.zeros(2), method="hmc")
    if not torch.cuda.is_available():  # a plain starting point goes to the card, and there is none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmcmc.create_mcmc_chain(t_dens, [0.0, 0.0])
    chain = tmcmc.create_mcmc_chain(t_dens, [0.0, 0.0], device="cpu")
    assert chain.state.x.shape == (1, 2) and chain.state.x.device.type == "cpu"


def test_adaptive_metropolis_chain_on_a_problem_samples_its_posterior():
    """tests/test_problem_mcmc.py::test_mcmc_chain_samples_gaussian, as 8
    chains in one batch."""
    mean, cov = torch.tensor([1.0, -1.0], dtype=torch.float64), torch.tensor([[2.0, 0.6], [0.6, 1.0]], dtype=torch.float64)
    problem = define_inference_problem(
        parameters=[("x", -20.0, 20.0), ("y", -20.0, 20.0)],
        log_likelihood=lambda th: MultivariateNormal(mean_=mean, cov=cov).log_prob(th),
        prior_distribution=["location", "location"], device="cpu", dtype=torch.float64, validate=False)
    g = torch.Generator().manual_seed(0)
    chain = tmcmc.create_mcmc_chain(problem, torch.zeros((8, 2), dtype=torch.float64))
    assert not chain.single and chain.problem is problem
    _, chain = tmcmc.iterate_mcmc(chain, g, 60, thinning=5)  # burn-in
    samples, chain = tmcmc.iterate_mcmc(chain, g, 400, thinning=5)
    assert samples.shape == (400, 8, 2) and int(chain.state.proposed[0]) == 460 * 5
    acc = chain.acceptance_rate
    assert acc.shape == (8,) and bool(((acc > 0.1) & (acc < 0.7)).all())
    flat = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), [1.0, -1.0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov.numpy(), atol=0.35)


def test_slice_chain_samples_a_correlated_gaussian():
    g = torch.Generator().manual_seed(1)
    chain = tmcmc.create_mcmc_chain(t_dens, torch.zeros(2, dtype=torch.float64), method="slice")
    samples, chain = tmcmc.iterate_mcmc(chain, g, 1500)
    assert samples.shape == (1500, 2)
    assert float(chain.acceptance_rate) == 1.0 and int(chain.state.step[0]) == 1500  # every update moved
    kept = samples[400:].numpy()
    np.testing.assert_allclose(kept.mean(0), [0.0, 0.0], atol=0.2)
    np.testing.assert_allclose(np.cov(kept.T), COV, atol=0.25)
    # the running covariance the directions follow has found the target's
    learned = (chain.state.chol[0] @ chain.state.chol[0].T).numpy()
    np.testing.assert_allclose(learned, COV, atol=0.3)
    # successive states decorrelate fast: lag-1 autocorrelation well below a random walk's
    c = kept - kept.mean(0)
    assert float((c[1:, 0] * c[:-1, 0]).mean() / c[:, 0].var()) < 0.6
