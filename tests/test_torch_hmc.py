"""The port's box bijection, HMC and ChEES kernels and HMC engine against
the JAX package, on the CPU in float64.

The step functions take their random numbers as inputs.  The tests replay
the JAX key schedule (``ops/hmc.py``: ``split(key, 4)`` for the phases, per
iteration ``split(k, num_iters)`` then ``split(k, n_chains)``, and in
``hmc_step`` ``split(key, 3)`` into momentum, jitter and acceptance keys;
``ops/chees.py``: per iteration ``split(key)`` into the momentum keys, one
per chain, and the acceptance key), feed the port the very numbers the JAX
function drew, and require the same chains: rtol 1e-10 on positions,
densities, step sizes and masses (only the summation order of small
products differs), counters exactly.  The bijection is held at rtol 1e-12.
The engine runs are held to the JAX tests' oracles.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.core.transforms import box_bijection as j_box
from bayesianinference_tpu.ops import chees as jchees
from bayesianinference_tpu.ops import hmc as jhmc
from bayesianinference_tpu_torch.core.transforms import box_bijection as t_box
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines.hmc import hmc_sample
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops import chees as tchees
from bayesianinference_tpu_torch.ops import hmc as thmc
from bayesianinference_tpu_torch.parallel.sharding import ShardAxis
from bayesianinference_tpu_torch.results import gelman_rubin

torch.set_num_threads(1)
RTOL = 1e-10
F64 = jnp.float64
LZ = -1e300


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- the box bijection

BOX_LO = [-2.0, 0.5, -np.inf, -np.inf, 3.0, 1.0]
BOX_HI = [3.0, 0.5, 4.0, np.inf, np.inf, 2.0]


def test_box_bijection_matches_jax_f64():
    """All four kinds of coordinate (two-sided, pinned, one-sided both
    ways, free) at z up to |30|, where softplus must not switch to the
    identity, and x on and outside the box edges."""
    jb, tb = j_box(jnp.asarray(BOX_LO), jnp.asarray(BOX_HI)), t_box(T(BOX_LO), T(BOX_HI))
    rng = np.random.default_rng(0)
    z = rng.normal(scale=8.0, size=(50, 6))
    z[0] = [30.0, -30.0, 25.0, -25.0, 35.0, -35.0]
    close(tb.to_x(T(z)), jax.vmap(jb.to_x)(jnp.asarray(z)), rtol=1e-12, atol=0)
    close(tb.log_jacobian(T(z)), jax.vmap(jb.log_jacobian)(jnp.asarray(z)), rtol=1e-12, atol=0)
    x = np.array(jax.vmap(jb.to_x)(jnp.asarray(z)))
    x[1] = [-2.0, 0.5, 4.0, 0.0, 3.0, 2.0]  # on the bounds
    x[2] = [-3.0, 0.5, 5.0, 1.0, 2.0, 0.0]  # outside them
    close(tb.to_z(T(x)), jax.vmap(jb.to_z)(jnp.asarray(x)), rtol=1e-12, atol=0)
    zr = np.clip(z[3:], -8.0, 8.0)  # beyond, sigmoid(z) rounds too close to 1 to invert
    free = [0, 2, 3, 4, 5]
    close(tb.to_z(tb.to_x(T(zr)))[:, free], zr[:, free], rtol=1e-6, atol=1e-6)


def test_box_bijection_f32_boundary_stays_finite():
    """tests/test_hmc.py's float32 regression in the port: a boundary point
    maps to a finite z and back inside the box; the JAX bijection agrees."""
    for lo, hi, xs in [
        ([0.0] * 3, [1.0] * 3, ([1.0] * 3, [0.0] * 3, [0.0, 0.5, 1.0])),
        ([0.0, -np.inf], [np.inf, 2.0], ([0.0, 2.0],)),
    ]:
        tb = t_box(torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32))
        jb = j_box(jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32))
        for x in xs:
            z = tb.to_z(torch.tensor(x, dtype=torch.float32))
            assert z.dtype == torch.float32 and bool(torch.isfinite(z).all()), (x, z)
            assert math.isfinite(float(tb.log_jacobian(z)))
            back = tb.to_x(z)
            fin_lo, fin_hi = np.isfinite(lo), np.isfinite(hi)
            assert (back.numpy()[fin_lo] >= np.asarray(lo)[fin_lo]).all()
            assert (back.numpy()[fin_hi] <= np.asarray(hi)[fin_hi]).all()
            close(z, jb.to_z(jnp.asarray(x, jnp.float32)), rtol=1e-6, atol=0)


# --- densities: a correlated Gaussian, and one with a hard edge (log-zero
# outside |x_i| < 1.2, so trajectories end on the sentinel)

PREC = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])


def j_gauss(x):
    return -0.5 * x @ jnp.asarray(PREC) @ x


def t_gauss(x):
    return -0.5 * ((x @ T(PREC)) * x).sum(dim=-1)


def j_edge(x):
    return jnp.where(jnp.all(jnp.abs(x) < 1.2), j_gauss(x), LZ)


def t_edge(x):
    return torch.where((x.abs() < 1.2).all(dim=-1), t_gauss(x), torch.full_like(x[:, 0], LZ))


DENSITIES = {"gauss": (j_gauss, t_gauss), "edge": (j_edge, t_edge)}
DENSE = np.array([[0.8, 0.2, 0.05], [0.2, 1.3, -0.1], [0.05, -0.1, 0.6]])
MASSES = {"diag": np.array([0.7, 1.4, 0.9]), "dense": DENSE}


def _step_draws(key, d):
    """The numbers ``hmc_step`` draws from ``key``."""
    k_mom, k_eps, k_acc = jax.random.split(key, 3)
    return (jax.random.normal(k_mom, (d,), F64), jax.random.uniform(k_eps, (), F64, minval=-1.0, maxval=1.0),
            jax.random.uniform(k_acc, (), F64))


def _draws_of(keys, d):
    """HMCDraws of one trajectory of the chains keyed by ``keys`` [C]."""
    return thmc.HMCDraws(*(T(a) for a in jax.vmap(lambda k: _step_draws(k, d))(keys)))


def _state_close(got: thmc.HMCState, want):
    close(got.x, want.x)
    close(got.log_density, want.log_density)
    close(got.grad, want.grad)
    for f in ("accepted", "proposed", "divergences"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("mass", sorted(MASSES))
@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_leapfrog_matches_jax(name, mass):
    jd, td = DENSITIES[name]
    rng = np.random.default_rng(1)
    chains, d = 12, 3
    x0, p0 = rng.uniform(-1.0, 1.0, (chains, d)), rng.normal(size=(chains, d))
    eps = rng.uniform(0.05, 0.4, chains)  # one step size per chain, as hmc_step's jitter gives
    inv_mass = MASSES[mass]
    jst = jax.vmap(lambda x: jhmc.hmc_init(x, jd))(jnp.asarray(x0))
    want = jax.vmap(lambda x, p, g, e: jhmc.leapfrog(x, p, g, jd, e, jnp.asarray(inv_mass), 5))(
        jst.x, jnp.asarray(p0), jst.grad, jnp.asarray(eps))
    tst = thmc.hmc_init(T(x0), td)
    close(tst.grad, jst.grad)
    got = thmc.leapfrog(tst.x, T(p0), tst.grad, td, T(eps), T(inv_mass), 5)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("mass", sorted(MASSES))
@pytest.mark.parametrize("name,step_size", [("gauss", 0.3), ("gauss", 2.5), ("edge", 0.6)])
def test_hmc_step_matches_jax_on_jax_draws(name, step_size, mass):
    """At step 2.5 the Gaussian's trajectories diverge (energy error above
    1000); on the edge density they end on the sentinel.  Both must have
    acceptance probability 0 in both packages."""
    jd, td = DENSITIES[name]
    chains, d = 16, 3
    x0 = np.random.default_rng(2).uniform(-1.0, 1.0, (chains, d))
    inv_mass = MASSES[mass]
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    jst = jax.vmap(lambda x: jhmc.hmc_init(x, jd))(jnp.asarray(x0))
    jout, jap = jax.vmap(lambda k, s: jhmc.hmc_step(k, s, jd, step_size, jnp.asarray(inv_mass), 6))(keys, jst)
    tout, tap = thmc.hmc_step(_draws_of(keys, d), thmc.hmc_init(T(x0), td), td, step_size, T(inv_mass), 6)
    _state_close(tout, jout)
    close(tap, jap)
    if step_size > 1:
        assert int(tout.divergences.sum()) > 0 and (tap[tout.divergences > 0] == 0).all()
    if name == "edge":
        assert (tap == 0).any() and (tap > 0).any()


def test_dual_averaging_matches_jax():
    aps = np.random.default_rng(4).uniform(0.2, 1.0, 20)
    jda = jhmc.dual_averaging_init(jnp.asarray(0.1, F64))
    tda = thmc.dual_averaging_init(torch.tensor(0.1, dtype=torch.float64))
    for a in aps:
        jda = jhmc.dual_averaging_update(jda, jnp.asarray(a), 0.8)
        tda = thmc.dual_averaging_update(tda, torch.tensor(a, dtype=torch.float64), 0.8)
        for f in ("log_eps", "log_eps_bar", "h_bar", "mu"):
            close(getattr(tda, f), getattr(jda, f), rtol=1e-13, atol=0)
    assert tda.t == int(jda.t) == 20


def _warmup_draws(key, chains, d, num_warmup, num_samples, thinning):
    """Every trajectory's draws of ``warmup_and_sample``, in run order."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    p3 = max(num_warmup - p1 - p2, 1)
    rows = []
    for k, p in ((k1, p1), (k2, p2), (k3, p3)):
        for kit in jax.random.split(k, p):
            rows.append(jax.random.split(kit, chains))
    for ks in jax.random.split(k4, num_samples):
        per_chain = jax.vmap(lambda kc: jax.random.split(kc, thinning))(jax.random.split(ks, chains))
        rows.extend(per_chain[:, j] for j in range(thinning))
    stacked = [_draws_of(keys, d) for keys in rows]
    return thmc.HMCDraws(*(torch.stack(a) for a in zip(*stacked)))


@pytest.mark.parametrize("dense,thinning", [(False, 1), (True, 1), (False, 2)])
def test_warmup_and_sample_matches_jax_on_jax_draws(dense, thinning):
    chains, d, num_warmup, num_samples, leapfrog = 4, 3, 9, 5, 4
    x0 = np.random.default_rng(5).normal(size=(chains, d))
    key = jax.random.PRNGKey(6)
    js, jst, jeps, jm = jhmc.warmup_and_sample(key, jnp.asarray(x0), j_gauss, num_warmup=num_warmup,
                                               num_samples=num_samples, num_leapfrog=leapfrog, thinning=thinning,
                                               dense_mass=dense)
    draws = _warmup_draws(key, chains, d, num_warmup, num_samples, thinning)
    ts, tst, teps, tm = thmc.warmup_and_sample(None, T(x0), t_gauss, num_warmup=num_warmup, num_samples=num_samples,
                                               num_leapfrog=leapfrog, thinning=thinning, dense_mass=dense,
                                               draws=draws)
    assert ts.shape == (chains, num_samples, d) and tm.shape == ((d, d) if dense else (d,))
    close(ts, js)
    close(teps, jeps)
    close(tm, jm)
    _state_close(tst, jst)


def test_momentum_factor_matches_jax():
    for m in MASSES.values():
        close(thmc.momentum_factor(T(m)), jhmc.momentum_factor(jnp.asarray(m)), rtol=1e-12)


# --- ChEES

def test_halton_base2_matches_jax():
    got = [tchees.halton_base2(i) for i in range(0, 70000, 7)]
    want = np.asarray(jax.vmap(jchees.halton_base2)(jnp.arange(0, 70000, 7)))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    np.testing.assert_allclose(got[:1], [0.0])
    np.testing.assert_allclose([tchees.halton_base2(i) for i in range(1, 6)], [0.5, 0.25, 0.75, 0.125, 0.625])


@pytest.fixture
def leapfrog_calls(monkeypatch):
    """The step counts that ChEES passes to ``leapfrog``, one per trajectory."""
    calls = []

    def counting(x, p, grad, fn, eps, inv_mass, num_steps):
        calls.append(num_steps)
        return thmc.leapfrog(x, p, grad, fn, eps, inv_mass, num_steps)

    monkeypatch.setattr(tchees, "leapfrog", counting)
    return calls


def _chees_draws_of(key, chains, d):
    k_mom, k_acc = jax.random.split(key)
    mom = jax.vmap(lambda k: jax.random.normal(k, (d,), F64))(jax.random.split(k_mom, chains))
    return tchees.ChEESDraws(momentum=T(mom), accept=T(jax.random.uniform(k_acc, (chains,), F64)))


@pytest.mark.parametrize("mass", sorted(MASSES))
@pytest.mark.parametrize("traj_time", [0.05, 1.3, 40.0])  # one step, several, clipped at max_leapfrog
def test_chees_iteration_matches_jax_on_jax_draws(traj_time, mass, leapfrog_calls):
    chains, d, eps, max_leapfrog = 16, 3, 0.2, 12
    x0 = np.random.default_rng(7).uniform(-1.0, 1.0, (chains, d))
    inv_mass = MASSES[mass]
    key = jax.random.PRNGKey(8)
    jst = jax.vmap(lambda x: jhmc.hmc_init(x, j_edge))(jnp.asarray(x0))
    jm = jnp.asarray(inv_mass)
    jout, jap, jg = jchees._chees_iteration(key, jst, j_edge, jnp.asarray(eps), jm, jhmc.momentum_factor(jm),
                                            jnp.asarray(traj_time), max_leapfrog)
    tm = T(inv_mass)
    (tout,), tap, tg = tchees._chees_iteration(ShardAxis.one("cpu"), [_chees_draws_of(key, chains, d)],
                                               [thmc.hmc_init(T(x0), t_edge)], [t_edge],
                                               torch.tensor(eps, dtype=torch.float64), [tm],
                                               [thmc.momentum_factor(tm)], torch.tensor(traj_time, dtype=torch.float64),
                                               max_leapfrog)
    _state_close(tout, jout)
    close(tap, jap)
    close(tg, jg)
    want_steps = min(max(math.ceil(traj_time / eps), 1), max_leapfrog)
    assert leapfrog_calls == [want_steps] and type(leapfrog_calls[0]) is int  # one trajectory of n steps


def _chees_run_draws(key, chains, d, num_warmup, num_samples, thinning):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    p3 = max(num_warmup - p1 - p2, 1)
    keys = [k for kk, p in ((k1, p1), (k2, p2), (k3, p3)) for k in jax.random.split(kk, p)]
    keys += [kt for ks in jax.random.split(k4, num_samples) for kt in jax.random.split(ks, thinning)]
    rows = [_chees_draws_of(k, chains, d) for k in keys]
    return tchees.ChEESDraws(*(torch.stack(a) for a in zip(*rows)))


@pytest.mark.parametrize("dense,thinning", [(False, 1), (True, 2)])
def test_chees_warmup_and_sample_matches_jax_on_jax_draws(dense, thinning, leapfrog_calls):
    chains, d, num_warmup, num_samples = 6, 3, 9, 4
    x0 = np.random.default_rng(9).normal(size=(chains, d))
    key = jax.random.PRNGKey(10)
    want = jchees.chees_warmup_and_sample(key, jnp.asarray(x0), j_gauss, num_warmup=num_warmup,
                                          num_samples=num_samples, max_leapfrog=16, thinning=thinning,
                                          dense_mass=dense)
    draws = _chees_run_draws(key, chains, d, num_warmup, num_samples, thinning)
    got = tchees.chees_warmup_and_sample(None, T(x0), t_gauss, num_warmup=num_warmup, num_samples=num_samples,
                                         max_leapfrog=16, thinning=thinning, dense_mass=dense, draws=draws)
    for i in (0, 2, 3, 4):  # samples, step size, inverse mass, trajectory length
        close(got[i], want[i])
    _state_close(got[1], want[1])
    assert len(leapfrog_calls) == draws.accept.shape[0]  # one leapfrog call of n steps per trajectory


# --- the engine against the JAX tests' oracles

def _conjugate_problem(data, tau0=3.0):
    return define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        likelihood=lambda th: Normal(th[0], 1.0),
        data=torch.tensor(data),
        prior_distribution=[Normal(0.0, tau0)],
        validate=False,
    )


@pytest.mark.parametrize("num_leapfrog", [8, "auto"])
def test_hmc_sample_conjugate_normal_oracle(num_leapfrog):
    """tests/test_hmc.py::test_hmc_problem_conjugate_posterior (and its
    ChEES twin) through the port, at 4 chains of 300 samples after 200
    warmup: the exact conjugate posterior's mean within 5 standard errors
    of an ESS of 200 (+0.01), its sd within 15 %, split R-hat below 1.05."""
    data = np.random.default_rng(1).normal(1.2, 1.0, 40)
    tau0 = 3.0
    post_prec = 1 / tau0**2 + len(data)
    post_mean = data.sum() / post_prec
    post_sd = post_prec**-0.5
    r = hmc_sample(_conjugate_problem(data, tau0), torch.Generator().manual_seed(0), num_chains=4,
                   num_samples=300, num_warmup=200, num_leapfrog=num_leapfrog, max_leapfrog=32)
    pooled = r.samples.reshape(-1).numpy()
    assert pooled.min() > -10.0 and pooled.max() < 10.0
    assert abs(pooled.mean() - post_mean) < 5 * post_sd / np.sqrt(200) + 0.01
    np.testing.assert_allclose(pooled.std(), post_sd, rtol=0.15)
    assert float(gelman_rubin(r.per_parameter_chains(0))) < 1.05
    assert float(r.trajectory_length) > 0 and r.samples.dtype == torch.float64


def test_chees_learns_long_trajectories_on_correlated_gaussian():
    """tests/test_hmc.py::test_chees_learns_long_trajectories_on_correlated_gaussian
    through the port: rho = 0.9 with a diagonal mass, 32 chains."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = T(np.linalg.inv(cov))

    def logdens(x):
        return -0.5 * x @ prec @ x

    x0 = torch.tensor(np.random.default_rng(2).normal(size=(32, 2)))
    r = hmc_sample(logdens, torch.Generator().manual_seed(0), num_chains=32, num_samples=400, num_warmup=450,
                   num_leapfrog="auto", starting_points=x0)
    tl, eps = float(r.trajectory_length), float(r.step_size)
    assert math.isfinite(tl) and tl / eps > 4.0, (tl, eps)
    assert float(r.acceptance_rates.mean()) > 0.55
    pooled = r.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(pooled.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.2)


def test_hmc_sample_dense_mass_and_validation():
    """The dense-mass path gives a [d, d] inverse mass; the JAX engine's
    argument checks hold; a Pathfinder start and a flow start meet the JAX
    tests' gates; numpy starts go to the card, which is absent here."""
    cov = np.array([[1.0, 1.8], [1.8, 4.0]])
    prec = T(np.linalg.inv(cov))

    def logdens(x):
        return -0.5 * x @ prec @ x

    x0 = torch.tensor(np.random.default_rng(1).normal(size=(8, 2)))
    r = hmc_sample(logdens, None, num_chains=8, num_samples=150, num_warmup=150, num_leapfrog=8, starting_points=x0,
                   dense_mass=True)
    m = r.inv_mass_diag.numpy()
    assert m.shape == (2, 2) and abs(m[0, 1] / np.sqrt(m[0, 0] * m[1, 1]) - 0.9) < 0.2
    assert int(r.divergences.sum()) == 0
    np.testing.assert_allclose(float(r.trajectory_length), 8 * float(r.step_size), rtol=1e-12)
    with pytest.raises(ValueError, match="starting_points"):
        hmc_sample(logdens, None)
    for bad in ("automatic", 0):
        with pytest.raises(ValueError, match="num_leapfrog"):
            hmc_sample(logdens, None, num_chains=2, num_leapfrog=bad, starting_points=x0[:2])
    problem = _conjugate_problem(np.zeros(3))
    # tests/test_flow_vi.py::test_hmc_flow_seeding: chains started at draws
    # of a flow-VI fit sit on the banana's curve
    banana = define_inference_problem(
        parameters=[("a", -6.0, 6.0), ("b", -4.0, 12.0)],
        log_likelihood=lambda th: -0.5 * (th[0] ** 2 / 4.0 + 4.0 * (th[1] - th[0] ** 2 / 2.0) ** 2),
        prior_distribution=["location", "location"], validate=False, device="cpu", dtype=torch.float64)
    res = hmc_sample(banana, torch.Generator().manual_seed(0), num_chains=8, num_samples=50, num_warmup=100,
                     num_leapfrog=16, starting_points="flow")
    draws = res.samples.reshape(-1, 2).numpy()
    assert np.isfinite(draws).all()
    assert abs((draws[:, 1] - draws[:, 0] ** 2 / 2.0).mean()) < 0.3
    with pytest.raises(ValueError):
        hmc_sample(problem, None, starting_points="bogus")
    with pytest.raises(ValueError, match="InferenceProblem"):
        hmc_sample(logdens, None, starting_points="pathfinder")
    # tests/test_pathfinder.py::test_hmc_pathfinder_init: chains started at
    # Pathfinder draws give calibrated moments after a short warmup
    rng = np.random.default_rng(1)
    data, tau0, n = rng.normal(1.2, 1.0, 40), 3.0, 40
    post_prec = 1 / tau0**2 + n
    r = hmc_sample(_conjugate_problem(data, tau0), torch.Generator().manual_seed(0), num_chains=4, num_samples=250,
                   num_warmup=100, num_leapfrog=8, starting_points="pathfinder")
    draws = r.samples.reshape(-1).numpy()
    np.testing.assert_allclose(draws.mean(), data.sum() / post_prec, atol=0.05)
    np.testing.assert_allclose(draws.std(), post_prec**-0.5, rtol=0.25)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hmc_sample(logdens, None, num_chains=8, starting_points=x0.numpy())
