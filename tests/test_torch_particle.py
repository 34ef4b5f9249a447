"""The port's particle filters and PMMH (``ops/particle.py``, ``ops/rbpf.py``,
``engines/particle.py``) against the JAX package, on the CPU in float64.

Replays: the samplers of the test models hand back the JAX key tree's
normals and uniforms (they ignore the generator), and the resampling
offsets go in as ``uniforms=``; the bootstrap filter, the forecast, the
RBPF, and four PMMH steps of one chain (two of warmup) on the bootstrap
filter and on the RBPF, agree with JAX draw for draw (1e-10).  Oracles, on
the port's own draws: the Kalman likelihood of the AR(1) of
``tests/test_particle.py`` (T = 150, P = 4096), the degenerate RBPF equal
to Kalman, the enumerated switching likelihood of ``tests/test_rbpf.py``.
Two chains of PMMH on the bootstrap filter and on the RBPF run as smokes;
PMMH against the exact grid posterior and PMMH's RBPF posterior are marked
slow, as in JAX; ``chip_smoke.py`` phase 19c runs the grid oracle at its
sizes on the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import particle as jpm
from bayesianinference_tpu.ops import kalman as jk
from bayesianinference_tpu.ops import particle as jpf
from bayesianinference_tpu.ops import rbpf as jrb
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.engines import particle as tpm
from bayesianinference_tpu_torch.ops import kalman as tk
from bayesianinference_tpu_torch.ops import particle as tpf
from bayesianinference_tpu_torch.ops import rbpf as trb

torch.set_num_threads(1)
F64 = jnp.float64
PHI, Q, R = 0.85, 0.3, 0.4


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _ar1_lgssm(phi=PHI):
    return jk.LGSSM(jnp.asarray([[phi]]), jnp.asarray([[Q**2]]), jnp.asarray([[1.0]]), jnp.asarray([[R**2]]),
                    jnp.zeros(1), jnp.asarray([[Q**2 / (1 - phi**2)]]))


def _j_ar1(phi=PHI):
    sd0 = jnp.sqrt(Q**2 / (1 - phi**2))
    return jpf.ParticleModel(
        lambda key, p: sd0 * jax.random.normal(key, (p, 1)),
        lambda key, x, t: phi * x + Q * jax.random.normal(key, x.shape, x.dtype),
        lambda x, y_t, t: -0.5 * ((y_t[0] - x[:, 0]) / R) ** 2 - jnp.log(R) - 0.5 * jnp.log(2 * jnp.pi))


def _obs_lp(x, y_t, t):
    return -0.5 * ((y_t[0] - x[:, 0]) / R) ** 2 - np.log(R) - 0.5 * np.log(2 * np.pi)


def _t_ar1(phi=PHI):
    """The AR(1) as a port model drawing from its generator."""
    sd0 = (Q**2 / (1 - phi**2)) ** 0.5

    def init(g, p):
        return sd0 * torch.randn((p, 1), generator=g, dtype=torch.float64)

    def trans(g, x, t):
        return phi * x + Q * torch.randn(x.shape, generator=g, dtype=x.dtype)

    return tpf.ParticleModel(init, trans, _obs_lp)


class _Replay:
    """Per filter call, JAX's init normals, transition normals [T, P, 1] and
    resampling uniforms [T], from the key ``particle_filter`` gets."""

    def __init__(self):
        self.calls = []

    def add(self, key, p, t_total):
        k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
        steps = [jax.random.split(k) for k in jax.random.split(k_scan, t_total)]
        self.calls.append((np.asarray(jax.random.normal(k_init, (p, 1))),
                           np.stack([np.asarray(jax.random.normal(kp, (p, 1), F64)) for kp, _ in steps]),
                           np.stack([np.asarray(jax.random.uniform(kr, (), F64)) for _, kr in steps])))
        return self

    def model(self, phi):
        """A port model popping the recorded normals in call order (each
        filter calls init once, then the transition at every step; PMMH
        builds the model anew for each call)."""
        def init(g, p):
            z0, zs, _ = self.calls.pop(0)
            self.zs = T(zs)
            return (Q**2 / (1 - phi**2)) ** 0.5 * T(z0)

        def trans(g, x, t):
            return phi * x + Q * self.zs[t]

        return tpf.ParticleModel(init, trans, _obs_lp)


@pytest.fixture(scope="module")
def ar1_data():
    _, y = jk.kalman_sample(jax.random.PRNGKey(0), _ar1_lgssm(), 150)
    return np.asarray(y)


def test_particle_filter_replays_jax(ar1_data):
    y, key = ar1_data, jax.random.PRNGKey(2)
    for thr in (0.5, 1.0, 0.0):
        want = jax.jit(lambda k: jpf.particle_filter(_j_ar1(), jnp.asarray(y), 256, k, thr))(key)
        rep = _Replay().add(key, 256, 150)
        u = rep.calls[0][2]
        got = tpf.particle_filter(rep.model(PHI), T(y), 256, None, thr, uniforms=T(u))
        close(got.log_likelihood, want.log_likelihood)
        close(got.filter_means, want.filter_means)
        close(got.ess, want.ess)


def test_particle_forecast_replays_jax(ar1_data):
    y, key = ar1_data, jax.random.PRNGKey(11)
    want = jax.jit(lambda k: jpf.particle_forecast(_j_ar1(), jnp.asarray(y), 5, 128, k))(key)
    z0, zs, u = _Replay().add(key, 128, 150).calls[0]
    res_key, fc_key = jax.random.split(jax.random.fold_in(key, 1))
    zs = np.concatenate([zs, np.stack([np.asarray(jax.random.normal(k, (128, 1), F64))
                                       for k in jax.random.split(fc_key, 5)])])
    u = np.append(u, np.asarray(jax.random.uniform(res_key, (), F64)))
    sd0 = (Q**2 / (1 - PHI**2)) ** 0.5
    model = tpf.ParticleModel(lambda g, p: sd0 * T(z0), lambda g, x, t: PHI * x + Q * T(zs[t]), _obs_lp)
    close(tpf.particle_forecast(model, T(y), 5, 128, None, uniforms=T(u)), want)


def test_pf_matches_kalman_likelihood_and_means(ar1_data):
    y = ar1_data
    exact = float(jk.kalman_log_likelihood(_ar1_lgssm(), jnp.asarray(y[:, 0])))
    g = torch.Generator().manual_seed(1)
    ests = np.array([float(tpf.particle_log_likelihood(_t_ar1(), T(y), 4096, g)) for _ in range(8)])
    assert abs(ests.mean() - exact) < 0.25 and ests.std() < 0.3, (ests, exact)
    res = tpf.particle_filter(_t_ar1(), T(y), 4096, torch.Generator().manual_seed(2))
    kf = tk.kalman_filter(tk.LGSSM(*(T(np.asarray(a)) for a in _ar1_lgssm()[:6])), T(y[:, 0]))
    close(res.filter_means[:, 0], kf.filtered_means[:, 0], rtol=0, atol=0.08)
    assert bool((res.ess > 100).all())
    never = tpf.particle_filter(_t_ar1(), T(y), 512, torch.Generator().manual_seed(3), ess_threshold=0.0)
    always = tpf.particle_filter(_t_ar1(), T(y), 512, torch.Generator().manual_seed(3), ess_threshold=1.0)
    assert float(never.ess[-1]) < 20 and float(always.ess[-1]) > 100
    assert np.isfinite(float(never.log_likelihood)) and np.isfinite(float(always.log_likelihood))


# ------------------------------------------------------------------- RBPF

A2 = np.array([[1.0, 1.0], [0.0, 1.0]])
Q2 = np.diag([0.05, 0.01])
H2 = np.array([[1.0, 0.0]])
P_STAY = 0.85
R_BY_REGIME = np.array([0.1, 2.5])


def _t_linear(r_of_u):
    a2, q2, h2 = T(A2), T(Q2), T(H2)
    z2, z1 = torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    return dict(linear_init=lambda u: (z2, torch.eye(2, dtype=torch.float64)),
                linear_transition=lambda u, t: (a2, z2, q2),
                linear_observation=lambda u, t: (h2, z1, r_of_u(u)))


def test_degenerate_rbpf_equals_kalman():
    y = np.random.default_rng(0).normal(size=30)
    lgssm = tk.LGSSM(T(A2), T(Q2), T(H2), T([[0.4]]), torch.zeros(2, dtype=torch.float64),
                     torch.eye(2, dtype=torch.float64))
    exact = float(tk.kalman_log_likelihood(lgssm, T(y)))
    model = trb.RBPFModel(init_sampler=lambda g, p: torch.zeros((p, 1), dtype=torch.float64),
                          transition_sampler=lambda g, u, t: u, **_t_linear(lambda u: T([[0.4]])))
    lls = [float(trb.rbpf_log_likelihood(model, T(y), 64, torch.Generator().manual_seed(s))) for s in range(4)]
    np.testing.assert_allclose(lls, exact, rtol=1e-10)
    res = trb.rbpf_filter(model, T(y), 16, torch.Generator().manual_seed(0))
    close(res.ess, np.full(30, 16.0), rtol=1e-6)
    assert bool(torch.isfinite(res.linear_means).all())


def _regime_r(u):
    return T(R_BY_REGIME)[u[0].long()].reshape(1, 1)


def _j_switching():
    def trans(k, u, t):
        return jnp.where(jax.random.uniform(k, (u.shape[0], 1)) < P_STAY, u, 1.0 - u)

    return jrb.RBPFModel(
        init_sampler=lambda k, p: (jax.random.uniform(k, (p, 1)) < 0.5).astype(F64),
        transition_sampler=trans,
        linear_init=lambda u: (jnp.zeros(2), jnp.eye(2)),
        linear_transition=lambda u, t: (jnp.asarray(A2), jnp.zeros(2), jnp.asarray(Q2)),
        linear_observation=lambda u, t: (jnp.asarray(H2), jnp.zeros(1),
                                         jnp.asarray(R_BY_REGIME, u.dtype)[u[0].astype(jnp.int32)].reshape(1, 1)))


def _t_switching():
    def init(g, p):
        return (torch.rand((p, 1), generator=g, dtype=torch.float64) < 0.5).to(torch.float64)

    def trans(g, u, t):
        return torch.where(torch.rand(u.shape, generator=g, dtype=u.dtype) < P_STAY, u, 1.0 - u)

    return trb.RBPFModel(init, trans, **_t_linear(_regime_r))


@pytest.fixture(scope="module")
def switching_data():
    rng = np.random.default_rng(1)
    regime = [0]
    for _ in range(8):
        regime.append(regime[-1] if rng.random() < P_STAY else 1 - regime[-1])
    x, ys = rng.normal(size=2), []
    for s in range(9):
        if s > 0:
            x = A2 @ x + rng.normal(size=2) * np.sqrt(np.diagonal(Q2))
        ys.append(x[0] + rng.normal() * np.sqrt(R_BY_REGIME[regime[s]]))
    return np.asarray(ys)


def _exact_switching_ll(y):
    """Sum of Kalman likelihoods over all 2^T regime paths (``tests/test_rbpf.py``)."""
    total = []
    for path in itertools.product([0, 1], repeat=y.size):
        lp = np.log(0.5) + sum(np.log(P_STAY if path[s] == path[s - 1] else 1 - P_STAY) for s in range(1, y.size))
        m, p = np.zeros(2), np.eye(2)
        for s in range(y.size):
            if s > 0:
                m, p = A2 @ m, A2 @ p @ A2.T + Q2
            sv = float((H2 @ p @ H2.T).item()) + R_BY_REGIME[path[s]]
            e = y[s] - float((H2 @ m).item())
            lp += -0.5 * e * e / sv - 0.5 * np.log(2 * np.pi * sv)
            k = (p @ H2.T / sv).ravel()
            m, p = m + k * e, p - np.outer(k, H2 @ p)
        total.append(lp)
    total = np.asarray(total)
    return total.max() + np.log(np.exp(total - total.max()).sum())


def test_rbpf_replays_jax(switching_data):
    y, key, p = switching_data, jax.random.PRNGKey(3), 64
    want = jax.jit(lambda k: jrb.rbpf_filter(_j_switching(), jnp.asarray(y), p, k, 0.9))(key)
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    steps = [jax.random.split(k) for k in jax.random.split(k_scan, y.size)]
    u0 = T(np.asarray(jax.random.uniform(k_init, (p, 1))))
    ut = [T(np.asarray(jax.random.uniform(kp, (p, 1)))) for kp, _ in steps]
    offsets = T([np.asarray(jax.random.uniform(kr, (), F64)) for _, kr in steps])
    model = trb.RBPFModel(lambda g, n: (u0 < 0.5).to(torch.float64),
                          lambda g, u, t: torch.where(ut[t] < P_STAY, u, 1.0 - u), **_t_linear(_regime_r))
    got = trb.rbpf_filter(model, T(y), p, None, 0.9, uniforms=offsets)
    for g_, w_ in zip(got, want):
        close(g_, w_)
    carried = interop.rbpf_result_from_numpy(want, device="cpu")
    assert isinstance(carried, trb.RBPFResult)
    for c_, g_ in zip(carried, got):
        close(c_, g_)


def test_rbpf_matches_enumeration_and_beats_the_plain_filter(switching_data):
    y = switching_data
    exact = _exact_switching_ll(y)
    g = torch.Generator().manual_seed(0)
    lls = np.array([float(trb.rbpf_log_likelihood(_t_switching(), T(y), 4096, g)) for _ in range(6)])
    np.testing.assert_allclose(lls.mean(), exact, atol=0.05)
    assert lls.std() < 0.08

    def pf_init(g, p):
        regime = (torch.rand((p, 1), generator=g, dtype=torch.float64) < 0.5).to(torch.float64)
        return torch.cat([regime, torch.randn((p, 2), generator=g, dtype=torch.float64)], dim=1)

    def pf_trans(g, u, t):
        stay = torch.rand((u.shape[0], 1), generator=g, dtype=u.dtype) < P_STAY
        eps = torch.randn((u.shape[0], 2), generator=g, dtype=u.dtype) * T(np.sqrt(np.diagonal(Q2)))
        return torch.cat([torch.where(stay, u[:, :1], 1.0 - u[:, :1]), u[:, 1:] @ T(A2).T + eps], dim=1)

    def pf_obs(u, y_t, t):
        r = T(R_BY_REGIME)[u[:, 0].long()]
        return -0.5 * (y_t - u[:, 1]) ** 2 / r - 0.5 * torch.log(2 * np.pi * r)

    pf = tpf.ParticleModel(pf_init, pf_trans, pf_obs)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
    rb = np.array([float(trb.rbpf_log_likelihood(_t_switching(), T(y), 512, g1)) for _ in range(12)])
    plain = np.array([float(tpf.particle_log_likelihood(pf, T(y), 512, g2)) for _ in range(12)])
    assert abs(rb.mean() - exact) < 0.15 and rb.std() < 0.5 * plain.std(), (rb.std(), plain.std())


# ------------------------------------------------------------------- PMMH

def test_pmmh_replays_jax_steps(ar1_data):
    """One chain, 2 warmup and 2 sampling steps: the start's estimate and
    every proposal's, the accept draws and the adaptation, on JAX's draws."""
    y, key, p, nw, ns = ar1_data[:40], jax.random.PRNGKey(8), 64, 2, 2
    want = jpm.pmmh_sample(lambda th: _j_ar1(phi=th[0]), jnp.asarray(y), parameters=[("phi", 0.3, 0.99)], key=key,
                           num_particles=p, num_samples=ns, num_warmup=nw, num_chains=1)
    (kc,) = jax.random.split(key, 1)
    k_init, k_run = jax.random.split(kc)
    rep = _Replay().add(jax.random.fold_in(k_init, 1), p, 40)
    normals, uniforms = [], []
    for k in jax.random.split(k_run, nw + ns):
        k_prop, k_pf, k_acc = jax.random.split(k, 3)
        normals.append(np.asarray(jax.random.normal(k_prop, (1,), F64)))
        rep.add(k_pf, p, 40)
        uniforms.append(np.asarray(jax.random.uniform(k_acc, (), F64, 1e-12, 1.0)))
    draws = tpm.PMMHDraws(normals=T(np.stack(normals))[:, None], uniforms=T(uniforms)[:, None],
                          resample=T(np.stack([c[2] for c in rep.calls]))[:, None])
    got = tpm.pmmh_sample(lambda th: rep.model(th[0]), T(y), [("phi", 0.3, 0.99)], None, num_particles=p,
                          num_samples=ns, num_warmup=nw, num_chains=1, draws=draws)
    assert not rep.calls  # every recorded filter call was replayed
    carried = interop.pmmh_result_from_numpy(want, device="cpu")
    for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales"):
        close(getattr(got, f), getattr(want, f))
        close(getattr(carried, f), getattr(got, f))


def test_pmmh_smoke_and_mesh(ar1_data):
    y = ar1_data[:60]
    res = tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), T(y), [("phi", 0.3, 0.99)],
                          torch.Generator().manual_seed(7), num_particles=128, num_samples=40, num_warmup=40,
                          num_chains=2)
    assert res.samples.shape == (2, 40, 1) and res.points.shape == (80, 1)
    assert bool(torch.isfinite(res.samples).all() and torch.isfinite(res.log_likelihoods).all())
    assert bool((res.proposal_scales > 0).all())
    # chains differ: each filter draws its own randomness
    assert not torch.equal(res.log_likelihoods[0], res.log_likelihoods[1])
    with pytest.raises(TypeError, match="takes the port's parallel.Mesh"):
        tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), T(y), [("phi", 0.3, 0.99)], None, mesh=object())


def test_pmmh_mesh_sharded_chains_match_the_unsharded_run(ar1_data):
    """``tests/test_particle.py::test_pmmh_mesh_sharded_chains_match_single_device``:
    8 chains over an 8-shard CPU mesh reproduce the unsharded run on the
    same generator exactly (no collective between chains; the unsharded
    run replays JAX's, ``test_pmmh_replays_jax_steps``), and a chain count
    that is not a multiple of the axis raises."""
    from bayesianinference_tpu_torch.parallel import make_mesh

    y = T(ar1_data[:40])
    kw = dict(num_particles=64, num_samples=20, num_warmup=20, num_chains=8)
    mesh = make_mesh(("chains",), devices=["cpu"] * 8)
    tpm_mesh = lambda devices: make_mesh(("chains",), devices=devices)  # noqa: E731
    r1 = tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), y, [("phi", 0.3, 0.99)], torch.Generator().manual_seed(8), **kw)
    r8 = tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), y, [("phi", 0.3, 0.99)], torch.Generator().manual_seed(8),
                         mesh=mesh, **kw)
    for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales"):
        np.testing.assert_array_equal(getattr(r8, f).numpy(), getattr(r1, f).numpy())
    # over two "devices" ("cpu" and "cpu:0" compare unequal) the chains go as two groups, each batch's filters
    # drawing from its own generator
    two = tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), y, [("phi", 0.3, 0.99)], torch.Generator().manual_seed(8),
                          mesh=tpm_mesh(["cpu"] * 4 + ["cpu:0"] * 4), **kw)
    assert two.samples.shape == r1.samples.shape and bool(torch.isfinite(two.log_likelihoods).all())
    with pytest.raises(ValueError, match="multiple"):
        tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), y, [("phi", 0.3, 0.99)], None, num_particles=32, num_samples=4,
                        num_warmup=4, num_chains=3, mesh=mesh)


def _t_ar1_fixed(phi, z0, zs):
    """The AR(1) on fixed normals (init [P, 1], transitions [T, P, 1]): a
    filter's estimate is a function of theta and its resampling offsets
    alone, whatever generator it is handed."""
    sd0 = (Q**2 / (1 - phi**2)) ** 0.5
    return tpf.ParticleModel(lambda g, p: sd0 * z0, lambda g, x, t: phi * x + Q * zs[t], _obs_lp)


@pytest.mark.parametrize("devices", [["cpu:0", "cpu", "cpu:0", "cpu"], ["cpu:0"] * 4])
def test_pmmh_device_groups_run_the_chains_of_the_unsharded_run(ar1_data, devices):
    """With the filters' noise fixed and every other draw given, a chain's
    path is a function of its start and its columns of ``PMMHDraws``: the
    chains split by device (two groups, chains {0, 1, 4, 5} and {2, 3, 6,
    7}, each on a generator of its own; or one group on a device that is
    not the problem's) are the unsharded run's chains, in its order."""
    from bayesianinference_tpu_torch.parallel import make_mesh

    y, p, nw, ns, c = T(ar1_data[:40]), 32, 6, 6, 8
    rng = np.random.default_rng(11)
    z0, zs = T(rng.normal(size=(p, 1))), T(rng.normal(size=(40, p, 1)))
    draws = tpm.pmmh_draws(torch.Generator().manual_seed(12), nw + ns, c, 1, 40, dtype=torch.float64, device="cpu")

    def run(mesh):
        return tpm.pmmh_sample(lambda th: _t_ar1_fixed(th[0], z0, zs), y, [("phi", 0.3, 0.99)],
                               torch.Generator().manual_seed(13), num_particles=p, num_samples=ns, num_warmup=nw,
                               num_chains=c, draws=draws, mesh=mesh)

    one, split = run(None), run(make_mesh(("chains",), devices=devices))
    assert len(set(one.log_likelihoods[:, -1].tolist())) == c  # every chain's path is its own
    for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales"):
        close(getattr(split, f), getattr(one, f), rtol=1e-12, atol=0.0)


def _t_calm_builder(model):
    """PMMH's builder for the switching model with the calm regime's
    observation variance r_calm = theta[0] (the other regime's fixed)."""
    def builder(theta):
        return model._replace(linear_observation=lambda u, t: (
            T(H2), torch.zeros(1, dtype=torch.float64),
            torch.stack([theta[0], torch.tensor(R_BY_REGIME[1], dtype=torch.float64)])[u[0].long()].reshape(1, 1)))

    return builder


class _SwitchingReplay:
    """Per RBPF call, JAX's init uniforms [P, 1], transition uniforms
    [T, P, 1] and resampling offsets [T], from the key ``rbpf_filter`` gets."""

    def __init__(self):
        self.calls = []

    def add(self, key, p, t_total):
        k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
        steps = [jax.random.split(k) for k in jax.random.split(k_scan, t_total)]
        self.calls.append((np.asarray(jax.random.uniform(k_init, (p, 1))),
                           np.stack([np.asarray(jax.random.uniform(kp, (p, 1))) for kp, _ in steps]),
                           np.stack([np.asarray(jax.random.uniform(kr, (), F64)) for _, kr in steps])))
        return self

    def model(self):
        """The switching model whose samplers pop the recorded uniforms in
        call order (init once a filter, then the transition at every step)."""
        def init(g, p):
            u0, us, _ = self.calls.pop(0)
            self.us = T(us)
            return (T(u0) < 0.5).to(torch.float64)

        def trans(g, u, t):
            return torch.where(self.us[t] < P_STAY, u, 1.0 - u)

        return trb.RBPFModel(init, trans, **_t_linear(_regime_r))


def test_pmmh_replays_jax_steps_on_rbpf(switching_data):
    """An RBPFModel builder dispatches PMMH to the marginalized filter, mapped
    over the chains by vmap: one chain, 2 warmup and 2 sampling steps, on
    JAX's draws, as the bootstrap replay above."""
    y, key, p, nw, ns = switching_data, jax.random.PRNGKey(9), 32, 2, 2

    def j_builder(theta):
        return _j_switching()._replace(linear_observation=lambda u, t: (
            jnp.asarray(H2), jnp.zeros(1),
            jnp.stack([theta[0], jnp.asarray(R_BY_REGIME[1], theta.dtype)])[u[0].astype(jnp.int32)].reshape(1, 1)))

    want = jpm.pmmh_sample(j_builder, jnp.asarray(y), parameters=[("r_calm", 0.01, 1.0)], key=key, num_particles=p,
                           num_samples=ns, num_warmup=nw, num_chains=1)
    (kc,) = jax.random.split(key, 1)
    k_init, k_run = jax.random.split(kc)
    rep = _SwitchingReplay().add(jax.random.fold_in(k_init, 1), p, y.size)
    normals, uniforms = [], []
    for k in jax.random.split(k_run, nw + ns):
        k_prop, k_pf, k_acc = jax.random.split(k, 3)
        normals.append(np.asarray(jax.random.normal(k_prop, (1,), F64)))
        rep.add(k_pf, p, y.size)
        uniforms.append(np.asarray(jax.random.uniform(k_acc, (), F64, 1e-12, 1.0)))
    draws = tpm.PMMHDraws(normals=T(np.stack(normals))[:, None], uniforms=T(uniforms)[:, None],
                          resample=T(np.stack([c[2] for c in rep.calls]))[:, None])
    got = tpm.pmmh_sample(_t_calm_builder(rep.model()), T(y), [("r_calm", 0.01, 1.0)], None, num_particles=p,
                          num_samples=ns, num_warmup=nw, num_chains=1, draws=draws)
    assert not rep.calls  # every recorded filter call was replayed
    for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales"):
        close(getattr(got, f), getattr(want, f))


def test_pmmh_rbpf_smoke(switching_data):
    """Two chains of the RBPF dispatch on the port's own draws: finite, and
    each chain's filters draw their own randomness."""
    res = tpm.pmmh_sample(_t_calm_builder(_t_switching()), T(switching_data), [("r_calm", 0.01, 1.0)],
                          torch.Generator().manual_seed(3), num_particles=32, num_samples=3, num_warmup=3,
                          num_chains=2)
    assert res.samples.shape == (2, 3, 1)
    assert bool(torch.isfinite(res.samples).all() and torch.isfinite(res.log_likelihoods).all())
    assert bool(((res.samples > 0.01) & (res.samples < 1.0)).all())
    assert not torch.equal(res.log_likelihoods[0], res.log_likelihoods[1])


@pytest.mark.slow
def test_pmmh_matches_exact_grid_posterior(ar1_data):
    y = ar1_data
    res = tpm.pmmh_sample(lambda th: _t_ar1(phi=th[0]), T(y), [("phi", 0.3, 0.99)],
                          torch.Generator().manual_seed(4), num_particles=512, num_samples=250, num_warmup=250,
                          num_chains=8)
    acc = res.acceptance_rate.numpy()
    assert np.all(acc > 0.05) and np.all(acc < 0.7), acc
    draws = res.points[:, 0].numpy()
    grid = np.linspace(0.3, 0.99, 200)
    logl = np.asarray(jax.vmap(lambda p: jk.kalman_log_likelihood(_ar1_lgssm(phi=p), jnp.asarray(y[:, 0])))(
        jnp.asarray(grid)))
    w = np.exp(logl - logl.max())
    w /= w.sum()
    mean_ref = float((grid * w).sum())
    sd_ref = float(np.sqrt(((grid - mean_ref) ** 2 * w).sum()))
    assert abs(draws.mean() - mean_ref) < 3.0 * sd_ref / np.sqrt(50)
    assert abs(draws.std() / sd_ref - 1.0) < 0.35


@pytest.mark.slow
def test_pmmh_dispatches_rbpf(switching_data):
    res = tpm.pmmh_sample(_t_calm_builder(_t_switching()), T(switching_data), [("r_calm", 0.01, 1.0)], torch.Generator().manual_seed(0),
                          num_particles=256, num_samples=150, num_warmup=150, num_chains=4)
    draws = res.samples.reshape(-1).numpy()
    assert np.isfinite(draws).all() and 0.02 < np.median(draws) < 0.6
