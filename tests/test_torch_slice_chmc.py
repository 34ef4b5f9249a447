"""Draw-for-draw parity of the port's slice and constrained-HMC chains, and
of the per-step adaptive-Metropolis pieces, with the JAX package, on the CPU
in float64.

Every port function takes its random numbers as inputs.  The tests replay
the JAX key schedule (``ops/slice.py``: ``split(key, 5)`` per update and one
``split`` per shrink pass; ``ops/chmc.py``: ``split(k)`` per trajectory;
``ops/metropolis.py::am_step``: ``split(key, 3)``) to get the very numbers
the JAX function drew, feed them to the port, and require the same chains:
rtol 1e-10 on positions and densities (only the summation order of the small
products differs), evaluation and move counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.ops import chmc as jchmc
from bayesianinference_tpu.ops import metropolis as jmet
from bayesianinference_tpu.ops import slice as jslice
from bayesianinference_tpu_torch.interop import (
    am_state_from_numpy,
    chmc_state_to_numpy,
    slice_state_from_numpy,
    slice_state_to_numpy,
)
from bayesianinference_tpu_torch.ops import chmc as tchmc
from bayesianinference_tpu_torch.ops import metropolis as tmet
from bayesianinference_tpu_torch.ops import slice as tslice

torch.set_num_threads(1)
RTOL = 1e-10
LZ = -1e300
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- densities: a Gaussian, and one with a hard edge (a box of half-width 1.2
# around the mode, so step-out hits its limit inside and shrink hits the edge)

def j_gauss(x):
    return -0.5 * jnp.sum(x * x)


def t_gauss(x):
    return -0.5 * (x * x).sum(dim=-1)


def j_edge(x):
    return jnp.where(jnp.all(jnp.abs(x) < 1.2), -0.5 * jnp.sum(x * x), LZ)


def t_edge(x):
    return torch.where((x.abs() < 1.2).all(dim=-1), -0.5 * (x * x).sum(dim=-1), torch.full_like(x[:, 0], LZ))


DENSITIES = {"gauss": (j_gauss, t_gauss), "edge": (j_edge, t_edge)}


def _slice_draws_of(key, d, max_shrink):
    """The numbers ``slice_update`` draws from ``key``."""
    k_dir, k_level, k_lo, _, k_shrink = jax.random.split(key, 5)
    us = []
    for _ in range(max_shrink):
        k_shrink, sub = jax.random.split(k_shrink)
        us.append(jax.random.uniform(sub, (), F64))
    return (jax.random.normal(k_dir, (d,), F64),
            jax.random.uniform(k_level, (), F64, minval=1e-12, maxval=1.0),
            jax.random.uniform(k_lo, (), F64), jnp.stack(us))


def _slice_setup(d, chains, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(chains, d))
    a = rng.normal(size=(d, d))
    chol = np.linalg.cholesky(a @ a.T / d + 0.3 * np.eye(d))
    return x0, chol


@pytest.mark.parametrize("name", ["gauss", "edge"])
@pytest.mark.parametrize("d", [3, 8])
def test_slice_update_matches_jax_on_jax_draws(d, name):
    jd, td = DENSITIES[name]
    chains = 16
    x0, chol = _slice_setup(d, chains, seed=d)
    keys = jax.random.split(jax.random.PRNGKey(d), chains)
    jstate = jax.vmap(lambda x: jslice.slice_init(x, jd))(jnp.asarray(x0))
    jout = jax.vmap(lambda k, s: jslice.slice_update(k, s, jd, jnp.asarray(chol), width=2.0))(keys, jstate)
    draws = tslice.SliceDraws(*(T(a) for a in jax.vmap(lambda k: _slice_draws_of(k, d, 32))(keys)))
    state = slice_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                                   device="cpu", dtype=torch.float64)
    out = slice_state_to_numpy(tslice.slice_update(state, td, T(chol), draws, width=2.0))
    close(out["x"], jout.x)
    close(out["log_density"], jout.log_density)
    np.testing.assert_array_equal(out["evals"], np.asarray(jout.evals))
    np.testing.assert_array_equal(out["moved"], np.asarray(jout.moved))


@pytest.mark.parametrize("d,name,max_shrink,max_stepout", [
    (3, "gauss", 32, 8), (8, "gauss", 32, 8), (3, "edge", 32, 8), (8, "edge", 32, 8),
    (3, "gauss", 32, 1),  # the step-out limit is hit on nearly every update
    (3, "edge", 2, 8), (8, "edge", 1, 8),  # shrink runs out: the chain stays put and does not count the move
])
def test_run_slice_chain_matches_jax_on_jax_draws(d, name, max_shrink, max_stepout):
    jd, td = DENSITIES[name]
    chains, updates = 16, 12
    x0, chol = _slice_setup(d, chains, seed=10 + d)
    keys = jax.random.split(jax.random.PRNGKey(100 + d), chains)
    jout = jax.vmap(lambda k, x: jslice.run_slice_chain(
        k, x, jd, jnp.asarray(chol), updates, max_stepout=max_stepout, max_shrink=max_shrink))(keys, jnp.asarray(x0))
    per_chain = jax.vmap(lambda k: jax.vmap(lambda ku: _slice_draws_of(ku, d, max_shrink))(
        jax.random.split(k, updates)))(keys)  # [C, S, ...]
    draws = tslice.SliceDraws(*(T(np.swapaxes(np.asarray(a), 0, 1)) for a in per_chain))
    out = tslice.run_slice_chain(draws, T(x0), td, T(chol), max_stepout=max_stepout)
    close(out.x, jout.x)
    close(out.log_density, jout.log_density)
    np.testing.assert_array_equal(out.evals.numpy(), np.asarray(jout.evals))
    np.testing.assert_array_equal(out.moved.numpy(), np.asarray(jout.moved))
    moved = out.moved.numpy()
    if max_shrink <= 2:
        assert (moved < updates).any(), "no chain ran out of shrink probes: the case tests nothing"
    else:
        assert (moved == updates).all()
    if max_stepout == 1:  # 1 init + per update 2 probes + 2 step-outs + shrinks: the limit binds
        assert (out.evals.numpy() >= 1 + 4 * updates).all()


def test_slice_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    one = tslice.slice_draws(g, 5, 3, dtype=torch.float64)
    many = tslice.slice_draws(g, 5, 3, num_updates=7, max_shrink=4, dtype=torch.float64)
    assert one.z.shape == (5, 3) and one.level.shape == (5,) and one.shrink.shape == (5, 32)
    assert many.z.shape == (7, 5, 3) and many.offset.shape == (7, 5) and many.shrink.shape == (7, 5, 4)
    assert bool((many.level >= 1e-12).all() & (many.level < 1).all() & (many.shrink >= 0).all() & (many.shrink < 1).all())


def test_slice_update_takes_one_factor_per_chain():
    """[C, d, d] factors (the chain API's running covariances) against the
    same update run chain by chain with its own [d, d] factor."""
    g = torch.Generator().manual_seed(1)
    chains, d = 6, 3
    x0 = torch.rand((chains, d), generator=g, dtype=torch.float64) - 0.5
    a = torch.randn((chains, d, d), generator=g, dtype=torch.float64)
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d, dtype=torch.float64))
    draws = tslice.slice_draws(g, chains, d, dtype=torch.float64)
    out = tslice.slice_update(tslice.slice_init(x0, t_edge), t_edge, chols, draws)
    for c in range(chains):
        one = tslice.slice_update(tslice.slice_init(x0[c:c + 1], t_edge), t_edge, chols[c],
                                  tslice.SliceDraws(*(a[c:c + 1] for a in draws)))
        close(out.x[c], one.x[0], rtol=1e-14)
        assert int(out.evals[c]) == int(one.evals[0])


# --- constrained HMC

def _chmc_draws_of(key, trajectories, d):
    def one(k):
        k_mom, k_acc = jax.random.split(k)
        return jax.random.normal(k_mom, (d,), F64), jax.random.uniform(k_acc, (), F64, minval=1e-38)

    return jax.vmap(one)(jax.random.split(key, trajectories))


def _ball(rng, n, d, radius):
    v = rng.normal(size=(n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True) * radius * rng.uniform(size=(n, 1)) ** (1.0 / d)


CHMC_CASES = {
    # tests/test_nested_sampling.py::test_chmc_chain_preserves_constraint
    "ball_in_wide_box": dict(dim=4, chains=64, box=5.0, threshold=-4.0, radius=np.sqrt(8.0) * 0.99,
                             chol_scale=0.8, trajectories=8, leapfrog=8, eps=0.3, prior="flat"),
    # a tight box and a long step: box reflections and double failures on most steps
    "tight_box": dict(dim=3, chains=32, box=1.0, threshold=-1.2, radius=0.9, chol_scale=1.0,
                      trajectories=6, leapfrog=5, eps=0.9, prior="flat"),
    # a prior with a gradient: the kicks and the Metropolis test matter
    "gaussian_prior": dict(dim=5, chains=16, box=4.0, threshold=-6.0, radius=2.0, chol_scale=0.7,
                           trajectories=5, leapfrog=6, eps=0.35, prior="gauss"),
}


@pytest.mark.parametrize("case", sorted(CHMC_CASES))
def test_run_chmc_chain_matches_jax_on_jax_draws(case):
    c = CHMC_CASES[case]
    dim, chains, n_traj = c["dim"], c["chains"], c["trajectories"]
    rng = np.random.default_rng(len(case))
    x0 = _ball(rng, chains, dim, c["radius"])
    lower, upper = np.full(dim, -c["box"]), np.full(dim, c["box"])
    a = rng.normal(size=(dim, dim)) * 0.1
    chol = np.linalg.cholesky(c["chol_scale"] ** 2 * np.eye(dim) + a @ a.T)
    gauss = c["prior"] == "gauss"

    j_prior = (lambda x: -0.25 * jnp.sum((x - 0.3) ** 2)) if gauss else (lambda x: jnp.asarray(0.0, x.dtype))
    t_prior = (lambda x: -0.25 * ((x - 0.3) ** 2).sum(dim=-1)) if gauss else (lambda x: torch.zeros_like(x[:, 0]))
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    jout = jax.vmap(lambda k, x: jchmc.run_chmc_chain(
        k, x, j_gauss, j_prior, jnp.asarray(c["threshold"]), jnp.asarray(chol), jnp.asarray(lower),
        jnp.asarray(upper), num_trajectories=n_traj, num_leapfrog=c["leapfrog"], step_size=c["eps"]))(
        keys, jnp.asarray(x0))
    mom, acc = jax.vmap(lambda k: _chmc_draws_of(k, n_traj, dim))(keys)  # [C, T, d], [C, T]
    draws = tchmc.CHMCDraws(momenta=T(np.swapaxes(np.asarray(mom), 0, 1)), accept=T(np.asarray(acc).T))
    out = chmc_state_to_numpy(tchmc.run_chmc_chain(
        draws, T(x0), t_gauss, t_prior, c["threshold"], T(chol), T(lower), T(upper), c["leapfrog"], c["eps"]))
    close(out["x"], jout.x)
    close(out["logl"], jout.logl)
    close(out["logp"], jout.logp)
    np.testing.assert_array_equal(out["accepted"], np.asarray(jout.accepted))
    np.testing.assert_array_equal(out["evals"], np.asarray(jout.evals))
    # the invariants of the JAX package's own test
    assert (out["logl"] > c["threshold"]).all()
    assert ((out["x"] >= lower) & (out["x"] <= upper)).all()
    assert (np.linalg.norm(out["x"] - x0, axis=1) > 1e-3).mean() > 0.5


def test_chmc_in_support_and_nan_gradients():
    """A constraint beyond the box is kept, and a likelihood whose gradient
    is NaN on part of the domain (sqrt of a negative number under the
    guard) neither poisons the chains nor moves them out of the constraint."""
    g = torch.Generator().manual_seed(0)
    chains, dim = 32, 3
    x0 = 0.3 + 0.4 * torch.rand((chains, dim), generator=g, dtype=torch.float64)
    lower, upper = torch.full((dim,), -2.0, dtype=torch.float64), torch.full((dim,), 2.0, dtype=torch.float64)

    def like(x):
        raw = -torch.sqrt(x[:, 0]) - 0.5 * (x * x).sum(dim=-1)  # NaN, with a NaN gradient, for x0 < 0
        return torch.where(torch.isfinite(raw), raw, torch.full_like(raw, LZ))

    support = lambda x: x[:, 1] > 0.1  # noqa: E731
    out = tchmc.run_chmc_chain(tchmc.chmc_draws(g, 6, chains, dim, dtype=torch.float64), x0, like,
                               lambda x: torch.zeros_like(x[:, 0]), -3.0, 0.8 * torch.eye(dim, dtype=torch.float64),
                               lower, upper, 6, 0.5, in_support=support)
    assert bool(torch.isfinite(out.x).all() & torch.isfinite(out.logl).all())
    assert bool((out.logl > -3.0).all() & support(out.x).all() & (out.x[:, 0] >= 0).all())
    close(out.logl, like(out.x), rtol=1e-12)
    assert int(out.accepted.sum()) > 0 and bool((out.evals == 2 * 6 * 6).all())


# --- the per-step adaptive-Metropolis pieces

@pytest.mark.parametrize("d", [1, 3, 7])
def test_chol_rank1_update_matches_jax(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(5, d, d))
    chol = np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) + np.eye(d))
    v = rng.normal(size=(5, d))
    want = jax.vmap(jmet.chol_rank1_update)(jnp.asarray(chol), jnp.asarray(v))
    got = tmet.chol_rank1_update(T(chol), T(v))
    close(got, want)
    close(got @ got.mT, chol @ np.swapaxes(chol, -1, -2) + v[:, :, None] * v[:, None, :], rtol=1e-12)


@pytest.mark.parametrize("step0", [0, 1, 25])
def test_welford_absorb_matches_jax(step0):
    rng = np.random.default_rng(step0)
    c, d = 6, 4
    a = rng.normal(size=(c, d, d))
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(d)
    chol = np.linalg.cholesky(cov)
    mean, x = rng.normal(size=(c, d)), rng.normal(size=(c, d))
    step = np.full((c,), step0, np.int32)
    want = jax.vmap(jmet.welford_absorb)(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(step), jnp.asarray(x))
    got = tmet.welford_absorb(T(mean), T(cov), T(step).to(torch.int64), T(x))
    want_c = jax.vmap(jmet.welford_absorb_chol)(jnp.asarray(mean), jnp.asarray(chol), jnp.asarray(step), jnp.asarray(x))
    got_c = tmet.welford_absorb_chol(T(mean), T(chol), T(step).to(torch.int64), T(x))
    for g, w in list(zip(got, want)) + list(zip(got_c, want_c)):
        close(g, w)
    if step0 > 0:  # the factor tracks the dense recursion
        close(got_c[1] @ got_c[1].mT, got[1], rtol=1e-10)


@pytest.mark.parametrize("t0,learn_delay", [(0, 5), (4, 5), (10, 5)])
def test_am_step_matches_jax_on_jax_draws(t0, learn_delay):
    c, d, steps = 8, 3, 12
    rng = np.random.default_rng(t0)
    x0 = jnp.asarray(0.4 * rng.normal(size=(c, d)))
    cov0 = jnp.asarray(np.diag([0.3, 0.1, 0.5]))
    jstate = jax.vmap(lambda x: jmet.am_init(x, j_edge, mean0=jnp.zeros(d) + 0.1, cov0=cov0, t0=t0))(x0)
    state = am_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                                device="cpu", dtype=torch.float64)
    key = jax.random.PRNGKey(t0)
    for _ in range(steps):  # the step count crosses the learn delay
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, c)
        jstate = jax.vmap(lambda k, s: jmet.am_step(k, s, j_edge, learn_delay))(keys, jstate)

        def draws_of(k):
            k_prop, k_floor, k_acc = jax.random.split(k, 3)
            return (jax.random.normal(k_prop, (d,), F64), jax.random.normal(k_floor, (d,), F64),
                    jnp.log(jax.random.uniform(k_acc, (), F64, minval=1e-38, maxval=1.0)))

        z, z2, log_u = (T(a) for a in jax.vmap(draws_of)(keys))
        state = tmet.am_step(state, t_edge, z, z2, log_u, learn_delay)
    for f in ("x", "log_density", "mean", "chol"):
        close(getattr(state, f), getattr(jstate, f))
    for f in ("step", "accepted", "proposed"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)))
    z, z2, log_u = tmet.am_step_draws(torch.Generator().manual_seed(0), state)
    assert z.shape == z2.shape == (c, d) and log_u.shape == (c,) and bool((log_u < 0).all())
