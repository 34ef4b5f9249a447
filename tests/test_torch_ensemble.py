"""The port's affine-invariant ensemble against the JAX package, on the CPU
in float64.

The half-updates take their random numbers as inputs.  The tests replay the
JAX key schedule (``_stretch_half``: ``split(key, 3)`` into partner,
stretch and acceptance keys; ``_de_half``: ``split(key, 5)``;
``ensemble_sweep``: ``split(key)`` into the two halves), feed the port those
numbers and require the same walkers: rtol 1e-10 on positions and
densities, acceptance exactly.  The engine is held to the JAX tests'
oracles: exact Gaussian moments for both moves and the conjugate posterior
through the box bijection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.ops import ensemble as jens
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines.ensemble import ensemble_sample
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops import ensemble as tens

torch.set_num_threads(1)
F64 = jnp.float64
PREC = np.array([[2.0, 0.8, 0.1], [0.8, 1.5, -0.3], [0.1, -0.3, 0.7]])
MU = np.array([0.5, -1.0, 2.0])


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def j_dens(x):
    z = x - jnp.asarray(MU)
    return -0.5 * z @ jnp.asarray(PREC) @ z


def t_dens(x):
    z = x - T(MU)
    return -0.5 * ((z @ T(PREC)) * z).sum(dim=-1)


def _half_draws(key, m, m2, d, move):
    if move == "stretch":
        k_j, k_z, k_u = jax.random.split(key, 3)
        return tens.StretchDraws(partner=T(jax.random.randint(k_j, (m,), 0, m2)).long(),
                                 z_u=T(jax.random.uniform(k_z, (m,), F64)),
                                 accept=T(jax.random.uniform(k_u, (m,), F64)))
    k_r1, k_r2, k_g, k_e, k_u = jax.random.split(key, 5)
    return tens.DEDraws(r1=T(jax.random.randint(k_r1, (m,), 0, m2)).long(),
                        r2_offset=T(jax.random.randint(k_r2, (m,), 0, m2 - 1)).long(),
                        jump=T(jax.random.uniform(k_g, (m,), F64)), noise=T(jax.random.normal(k_e, (m, d), F64)),
                        accept=T(jax.random.uniform(k_u, (m,), F64)))


@pytest.mark.parametrize("move,knob", [("stretch", 2.0), ("stretch", 1.5), ("de", 0.1), ("de", 0.6)])
def test_half_update_matches_jax_on_jax_draws(move, knob):
    rng = np.random.default_rng(0)
    m, m2, d = 24, 20, 3
    x_act, x_comp = rng.normal(size=(m, d)), rng.normal(size=(m2, d))
    lp_act = np.asarray(jax.vmap(j_dens)(jnp.asarray(x_act)))
    key = jax.random.PRNGKey(1)
    jhalf = jens._stretch_half if move == "stretch" else jens._de_half
    thalf = tens._stretch_half if move == "stretch" else tens._de_half
    want = jhalf(key, jnp.asarray(x_act), jnp.asarray(lp_act), jnp.asarray(x_comp), jax.vmap(j_dens), knob)
    got = thalf(_half_draws(key, m, m2, d, move), T(x_act), T(lp_act), T(x_comp), t_dens, knob)
    close(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < m


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_ensemble_sweep_matches_jax_on_jax_draws(move):
    w, d, sweeps = 16, 3, 6
    x0 = np.random.default_rng(2).normal(size=(w, d))
    jst = jens.ensemble_init(jnp.asarray(x0), jax.vmap(j_dens))
    tst = tens.ensemble_init(T(x0), t_dens)
    for k in jax.random.split(jax.random.PRNGKey(3), sweeps):
        jst = jens.ensemble_sweep(k, jst, jax.vmap(j_dens), move=move)
        k0, k1 = jax.random.split(k)
        draws = (_half_draws(k0, w // 2, w // 2, d, move), _half_draws(k1, w // 2, w // 2, d, move))
        tst = tens.ensemble_sweep(draws, tst, t_dens, move=move)
    close(tst.x, jst.x)
    close(tst.log_density, jst.log_density)
    np.testing.assert_array_equal(tst.accepted.numpy(), np.asarray(jst.accepted))
    np.testing.assert_array_equal(tst.proposed.numpy(), np.asarray(jst.proposed))
    # every walker's cached density is its position's
    close(tst.log_density, t_dens(tst.x), rtol=1e-12)


def test_ensemble_draws_shapes():
    g = torch.Generator().manual_seed(0)
    s0, s1 = tens.ensemble_draws(g, 10, 3, dtype=torch.float64)
    assert s0.partner.shape == (5,) and int(s0.partner.max()) < 5 and s1.z_u.shape == (5,)
    d0, _ = tens.ensemble_draws(g, 10, 3, move="de", dtype=torch.float64)
    assert d0.noise.shape == (5, 3) and int(d0.r2_offset.max()) < 4


def _gauss_logdens(prec, mu):
    prec, mu = T(prec), T(mu)

    def logdens(x):
        z = x - mu
        return -0.5 * z @ prec @ z

    return logdens


def test_walker_count_validation():
    """tests/test_ensemble.py::test_walker_count_validation in the port."""
    with pytest.raises(ValueError, match="even"):
        ensemble_sample(_gauss_logdens(np.eye(2), np.zeros(2)), None, num_walkers=7,
                        starting_points=torch.zeros((7, 2), dtype=torch.float64))
    problem = define_inference_problem(
        parameters=[("a", -5.0, 5.0), ("b", -5.0, 5.0)],
        likelihood=lambda th: Normal(th[0] + th[1], 1.0),
        data=torch.tensor([0.0], dtype=torch.float64),
        validate=False,
    )
    with pytest.raises(ValueError, match="2d"):
        ensemble_sample(problem, None, num_walkers=4)
    with pytest.raises(ValueError, match="2d"):
        ensemble_sample(_gauss_logdens(np.eye(4), np.zeros(4)), None, num_walkers=8,
                        starting_points=torch.zeros((8, 4), dtype=torch.float64))


def test_move_knob_validation_and_plumbing():
    """tests/test_ensemble.py::test_move_knob_validation_and_plumbing in the
    port: the other move's knob raises, and gamma_jump_prob reaches the DE
    kernel (the same generator seed and starts give other walks)."""
    logdens = _gauss_logdens(np.eye(2), np.zeros(2))
    pts = torch.randn((16, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    with pytest.raises(ValueError, match="gamma_jump_prob"):
        ensemble_sample(logdens, None, num_walkers=16, starting_points=pts, move="stretch", gamma_jump_prob=0.3)
    with pytest.raises(ValueError, match="stretch_scale"):
        ensemble_sample(logdens, None, num_walkers=16, starting_points=pts, move="de", stretch_scale=3.0)
    with pytest.raises(ValueError, match="unknown move"):
        ensemble_sample(logdens, None, num_walkers=16, starting_points=pts, move="walk")

    def run(p):
        return ensemble_sample(logdens, torch.Generator().manual_seed(1), num_walkers=16, starting_points=pts,
                               num_warmup=0, num_samples=20, move="de", gamma_jump_prob=p).samples

    assert not torch.allclose(run(1.0), run(0.0))
    # numpy starts go to the card unless the CPU is asked for
    r = ensemble_sample(logdens, None, num_walkers=16, starting_points=pts.numpy(), num_warmup=0, num_samples=2,
                        device="cpu")
    assert r.samples.device.type == "cpu" and r.samples.shape == (16, 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ensemble_sample(logdens, None, num_walkers=16, starting_points=pts.numpy())


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_gaussian_moments(move):
    """tests/test_ensemble.py::test_gaussian_moments in the port."""
    cov = np.array([[1.0, 0.9], [0.9, 1.3]])
    mu = np.array([1.0, -2.0])
    x0 = torch.tensor(np.random.default_rng(0).normal(size=(64, 2)))
    r = ensemble_sample(_gauss_logdens(np.linalg.inv(cov), mu), torch.Generator().manual_seed(0), num_walkers=64,
                        num_samples=400, num_warmup=400, move=move, starting_points=x0)
    assert 0.05 < float(r.acceptance_rates.mean()) < 0.9
    pooled = r.posterior_samples().points.numpy()
    np.testing.assert_allclose(pooled.mean(axis=0), mu, atol=0.12)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.2 * np.max(np.abs(cov)))
    assert r.move == move and r.param_names == ("x0", "x1")


def test_problem_conjugate_posterior():
    """tests/test_ensemble.py::test_problem_conjugate_posterior in the port:
    the mu-only Normal model through the box bijection from prior draws."""
    data = np.random.default_rng(1).normal(1.2, 1.0, 40)
    tau0 = 3.0
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        likelihood=lambda th: Normal(th[0], 1.0),
        data=torch.tensor(data),
        prior_distribution=[Normal(0.0, tau0)],
        validate=False,
    )
    post_prec = 1 / tau0**2 + len(data)
    post_mean = data.sum() / post_prec
    post_sd = post_prec**-0.5
    r = ensemble_sample(problem, torch.Generator().manual_seed(0), num_walkers=32, num_samples=300, num_warmup=300)
    assert r.param_names == ("mu",)
    pooled = r.posterior_samples().points[:, 0].numpy()
    np.testing.assert_allclose(pooled.mean(), post_mean, atol=3 * post_sd / 10)
    np.testing.assert_allclose(pooled.std(), post_sd, rtol=0.2)
    assert r.per_parameter_chains(0).shape == (32, 300)
    assert pooled.min() > -10.0 and pooled.max() < 10.0
