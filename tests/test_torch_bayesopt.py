"""The port's Bayesian optimization (``engines/bayesopt.py``) against the
JAX package, on the CPU.

Parity tests put the same numpy-seeded inputs through both packages, in
float64; the suggestions take the JAX key tree's draws as inputs
(``DesignDraws``: each design column's jitter and permutation;
``BODraws``: each suggestion's candidates, local normals and Thompson
normals).  Oracle tests hold the port to the oracles of
``tests/test_bayesopt.py``, one counterpart each, at the JAX tests'
float32.  Tolerances:

* masked moments, masked logML and its gradient, log EI and its
  gradient: rtol 1e-12 against the JAX functions, 1e-10 against the dense
  GP on the valid block;
* the hyperparameter Adam steps, a suggestion, and whole runs: every
  hyperparameter, point and value at 1e-9 of its largest entry (float64,
  draw for draw; the port's SE covariance takes direct differences where
  the JAX ``_ard_se_matrix`` takes the Gram form, a last-bit difference);
* a JAX state carried over by ``interop``: exact.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from bayesianinference_tpu.engines import bayesopt as jbo
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.engines import bayesopt as tbo
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a), dtype=dtype)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _jax_design(key, n, d, dtype=jnp.float64):
    """``_scrambled_grid``'s draws: each column's uniforms and the
    permutation that ``jax.random.permutation`` applies."""
    keys = jax.random.split(key, d + 1)
    jit, order = [], []
    for j in range(d):
        kp, kj = jax.random.split(keys[j])
        jit.append(np.asarray(jax.random.uniform(kj, (n,), dtype)))
        order.append(np.asarray(jax.random.permutation(kp, n)))
    return tbo.DesignDraws(T(np.stack(jit)), torch.tensor(np.stack(order)))


def _jax_step_draws(key, cfg, d, dtype=jnp.float64):
    """``_suggest01``'s draws from one suggestion key."""
    k_cand, k_draw, k_local = jax.random.split(key, 3)
    q = cfg.num_candidates
    return tbo.BODraws(T(jax.random.uniform(k_cand, (q, d), dtype)), T(jax.random.normal(k_local, (q // 2, d), dtype)),
                       T(jax.random.normal(k_draw, (q,), dtype)), T(jax.random.normal(k_draw, (1,), dtype)))


def _padded(rng, n, cap, d, fill):
    x = rng.uniform(size=(n, d))
    x_pad = np.full((cap, d), fill)
    x_pad[:n] = x
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return x, x_pad, mask


# ---------------------------------------------------------------------------
# the masked GP and the acquisition
# ---------------------------------------------------------------------------


def test_masked_gp_moments_match_jax_and_dense():
    rng = np.random.default_rng(0)
    n, cap, d = 7, 12, 2
    x, x_pad, mask = _padded(rng, n, cap, d, 0.33)
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n)
    y_pad = np.zeros(cap)
    y_pad[:n] = y
    xq = rng.uniform(size=(5, d))
    ell, var, nug = np.array([0.4, 0.7]), 1.7, 1e-3
    hyp = (math.log(var), np.log(ell), math.log(nug))
    got = tbo.masked_gp_moments(T(x_pad), T(y_pad), torch.tensor(mask), T(xq), *map(T, hyp))
    want = jbo.masked_gp_moments(x_pad, y_pad, jnp.asarray(mask), xq, *map(jnp.asarray, hyp))
    dense = tgk.gp_posterior_moments(tgk.se_kernel(variance=var, lengthscale=T(ell)), T(x), T(y), T(xq), nugget=nug,
                                     query_nugget=False)
    for a, b, c in zip(got, want, dense):
        close(a, b, rtol=1e-12)
        close(a, c, rtol=1e-10)


def test_masked_gp_logml_and_gradient_match_jax_and_dense():
    rng = np.random.default_rng(1)
    n, cap = 9, 16
    x, x_pad, mask = _padded(rng, n, cap, 1, 0.5)
    y = rng.normal(size=n)
    y_pad = np.zeros(cap)
    y_pad[:n] = y
    hyp = (math.log(0.8), np.full((1,), math.log(0.25)), math.log(0.05))
    args = [T(h).requires_grad_(True) for h in hyp]
    got = tbo.masked_gp_log_marginal(T(x_pad), T(y_pad), torch.tensor(mask), *args)
    grads = torch.autograd.grad(got, args)
    jf = lambda *h: jbo.masked_gp_log_marginal(x_pad, y_pad, jnp.asarray(mask), *h)  # noqa: E731
    want, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, hyp))
    close(got.detach(), want, rtol=1e-12)
    for a, b in zip(grads, jgrads):
        close_rel(a, b, 1e-12)
    k = tgk.covariance_matrix(tgk.se_kernel(variance=0.8, lengthscale=0.25), T(x), nugget=0.05)
    close(got.detach(), tgk.gp_log_marginal_likelihood(k, T(y)), rtol=1e-10)


def test_log_ei_matches_jax_and_closed_form():
    """log EI against the JAX function and the scipy closed form, with a
    deep-tail point where the naive form underflows, and its gradient."""
    mean, std, best = np.array([1.2, 0.0, -3.0, -30.0]), np.array([0.5, 1.0, 0.7, 1.0]), 0.3
    m = T(mean).requires_grad_(True)
    got = tbo.log_expected_improvement(m, T(std), best)
    (g,) = torch.autograd.grad(got.sum(), m)
    jf = lambda mm: jbo.log_expected_improvement(mm, jnp.asarray(std), best)  # noqa: E731
    close(got.detach(), jf(jnp.asarray(mean)), rtol=1e-12)
    close(g, jax.grad(lambda mm: jf(mm).sum())(jnp.asarray(mean)), rtol=1e-12)
    z = (mean - best) / std
    close(got.detach()[:3], np.log(std * (z * sps.norm.cdf(z) + sps.norm.pdf(z)))[:3], rtol=1e-4)
    got = got.detach()
    assert np.isfinite(float(got[3])) and float(got[3]) < float(got[2])


# ---------------------------------------------------------------------------
# the suggestion and the loop on the JAX draws (float64)
# ---------------------------------------------------------------------------


def _state_pair(acq="log_ei", nugget=None):
    """A state with 9 observations of a 2-d function in a capacity of 14,
    in both packages, and the configuration."""
    rng = np.random.default_rng(2)
    cfg = jbo.BayesOptConfig(acquisition=acq, num_candidates=64, hyper_steps=5, refine_steps=4, nugget=nugget)
    lower, upper = np.array([-2.0, -1.0]), np.array([2.0, 3.0])
    jstate, _ = jbo.bo_init(jnp.asarray(lower), jnp.asarray(upper), 14, jax.random.PRNGKey(0), num_init=4,
                            dtype=jnp.float64)
    tstate, _ = tbo.bo_init(T(lower), T(upper), 14, num_init=4, dtype=torch.float64,
                            draws=_jax_design(jax.random.PRNGKey(0), 4, 2))
    for _ in range(9):
        x = lower + (upper - lower) * rng.uniform(size=2)
        y = float(np.sum((x - 0.3) ** 2) + np.sin(3 * x[0]))
        jstate = jbo.bo_observe(jstate, jnp.asarray(x), y)
        tstate = tbo.bo_observe(tstate, T(x), y)
    return jstate, tstate, tbo.BayesOptConfig(**vars(cfg)), cfg


def test_hyper_adam_matches_jax():
    jstate, tstate, tcfg, cfg = _state_pair()
    span = tstate.upper - tstate.lower
    x01 = (tstate.x - tstate.lower) / span
    mu, sd = tbo._standardized(tstate.y, tstate.mask)
    ys = torch.where(tstate.mask, (tstate.y - mu) / sd, 0.0)
    for opt_nugget in (True, False):
        got = tbo._hyper_adam(x01, ys, tstate.mask, (tstate.log_var, tstate.log_ell, tstate.log_nugget), 6, 0.08,
                              opt_nugget=opt_nugget)
        jx01 = (jstate.x - jstate.lower) / (jstate.upper - jstate.lower)
        jmu, jsd = jbo._standardized(jstate.y, jstate.mask)
        jys = jnp.where(jstate.mask, (jstate.y - jmu) / jsd, 0.0)
        want = jbo._hyper_adam(jx01, jys, jstate.mask, (jstate.log_var, jstate.log_ell, jstate.log_nugget), 6, 0.08,
                               opt_nugget=opt_nugget)
        for a, b in zip(got, want):
            close_rel(a, b, 1e-9)


@pytest.mark.parametrize("acq,nugget", [("log_ei", None), ("ucb", None), ("thompson", None), ("log_ei", 1e-6)])
def test_suggest_replays_jax(acq, nugget):
    jstate, tstate, tcfg, cfg = _state_pair(acq, nugget)
    key = jax.random.PRNGKey(5)
    jstate2, jx = jbo.bo_suggest(jstate, key, cfg)
    tstate2, tx = tbo.bo_suggest(tstate, _jax_step_draws(key, cfg, 2), tcfg)
    close_rel(tx, jx, 1e-9)
    for name in ("log_var", "log_ell", "log_nugget"):
        close_rel(getattr(tstate2, name), getattr(jstate2, name), 1e-9)
    # the JAX state carried over by interop suggests the same point
    carried = interop.bayes_opt_state_from_numpy(jstate, device="cpu")
    for name in ("x", "y", "mask", "log_ell"):
        close(getattr(carried, name), getattr(jstate, name), rtol=0)
    assert carried.n == int(jstate.n) and carried.mask.dtype == torch.bool
    close_rel(tbo.bo_suggest(carried, _jax_step_draws(key, cfg, 2), tcfg)[1], jx, 1e-9)
    back = interop.bayes_opt_state_to_numpy(carried)
    close(back["y"], jstate.y, rtol=0)


def test_bayes_optimize_replays_jax_float64():
    """A whole run draw for draw: the design, every suggestion and every
    value of the history."""
    opt = np.array([0.3, -0.6])
    cfg = jbo.BayesOptConfig(num_candidates=64, hyper_steps=4, refine_steps=4)
    key = jax.random.PRNGKey(3)
    want = jbo.bayes_optimize(lambda x: jnp.sum((x - opt) ** 2), jnp.asarray([-2.0, -2.0]), jnp.asarray([2.0, 2.0]),
                              key, num_steps=6, num_init=5, config=cfg, dtype=jnp.float64)
    k_init, k_loop = jax.random.split(key)
    steps = [_jax_step_draws(k, cfg, 2) for k in jax.random.split(k_loop, 6)]
    draws = (_jax_design(k_init, 5, 2), tbo.BODraws(*(torch.stack(t) for t in zip(*steps))))
    got = tbo.bayes_optimize(lambda x: torch.sum((x - T(opt)) ** 2), T([-2.0, -2.0]), T([2.0, 2.0]), num_steps=6,
                             num_init=5, config=tbo.BayesOptConfig(**vars(cfg)), dtype=torch.float64, draws=draws)
    close_rel(got.x_history, want.x_history, 1e-9)
    close_rel(got.y_history, want.y_history, 1e-9)
    close_rel(got.state.log_ell, want.state.log_ell, 1e-9)
    close(got.y_best, want.y_best, rtol=1e-9)
    assert got.state.n == 11 and bool(got.state.mask.all())


# ---------------------------------------------------------------------------
# the JAX tests' oracles on the port, on the JAX tests' own random numbers
# (float32, their dtype).  BO misses these gates at some seeds in both
# packages alike: on Branin's ask/tell run, 2 of the 10 keys 0-9 in float64
# (y_best 1.944 and 1.112) with the port's results draw for draw the JAX
# function's; so each test replays the key of its JAX counterpart.
# ---------------------------------------------------------------------------


def _jax_run_draws(key, cfg, d, num_init, num_steps):
    """``bayes_optimize``'s draws: the design from the first half of the
    key, one suggestion's from each of ``num_steps`` splits of the second."""
    k_init, k_loop = jax.random.split(key)
    steps = [_jax_step_draws(k, cfg, d, jnp.float32) for k in jax.random.split(k_loop, num_steps)]
    design = _jax_design(k_init, num_init, d, jnp.float32)
    f32 = lambda dr: type(dr)(*(t.float() if t.is_floating_point() else t for t in dr))  # noqa: E731
    return f32(design), f32(tbo.BODraws(*(torch.stack(t) for t in zip(*steps))))


def test_bayes_optimize_quadratic_beats_random():
    """2-D quadratic bowl: 8 init + 16 BO steps land far closer to the
    optimum than a 24-point random search."""
    opt = torch.tensor([0.3, -0.6])
    f = lambda x: torch.sum((x - opt) ** 2)  # noqa: E731
    cfg = tbo.BayesOptConfig(num_candidates=256, hyper_steps=6)
    res = tbo.bayes_optimize(f, torch.tensor([-2.0, -2.0]), torch.tensor([2.0, 2.0]), num_steps=16, num_init=8,
                             config=cfg, draws=_jax_run_draws(jax.random.PRNGKey(3), cfg, 2, 8, 16))
    assert res.y_history.shape == (24,) and res.y_history.dtype == torch.float32
    xs = torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(99), (24, 2), minval=-2.0, maxval=2.0)))
    y_rand = float(torch.min(torch.stack([f(x) for x in xs.float()])))
    assert float(res.y_best) < 0.25 * y_rand and float(res.y_best) < 0.02
    close(float(res.y_best), float(torch.min(res.y_history)), rtol=1e-6)
    assert bool(res.state.mask.all())


def _branin(x):
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5 / np.pi
    r, s, t = 6.0, 10.0, 1 / (8 * np.pi)
    return a * (x[1] - b * x[0] ** 2 + c * x[0] - r) ** 2 + s * (1 - t) * np.cos(x[0]) + s


BRANIN_DRAWS = Path(__file__).parent / "data" / "bo_branin_jax_draws.npz"


def branin_jax_draws() -> dict:
    """The random numbers of ``tests/test_bayesopt.py::test_ask_tell_agrees_and_improves``
    (float32): the design of ``PRNGKey(7)``, the suggestions of
    ``PRNGKey(100 + i)``, i < 20, at 256 candidates.  ``chip_smoke.py``
    phase 15d reads them from ``BRANIN_DRAWS``, which
    ``python tests/test_torch_bayesopt.py`` writes."""
    cfg = jbo.BayesOptConfig(num_candidates=256, hyper_steps=6)
    design = _jax_design(jax.random.PRNGKey(7), 6, 2, jnp.float32)
    steps = [_jax_step_draws(jax.random.PRNGKey(100 + i), cfg, 2, jnp.float32) for i in range(20)]
    out = {f"design_{k}": v.numpy() for k, v in design._asdict().items()}
    out.update({k: torch.stack(v).numpy() for k, v in zip(tbo.BODraws._fields, zip(*steps))})
    out["design_jitter"] = out["design_jitter"].astype(np.float32)
    for k in tbo.BODraws._fields:
        out[k] = out[k].astype(np.float32)
    return out


def test_ask_tell_agrees_and_improves():
    """Branin through the ask/tell front end: within 0.7 of the global
    minimum 0.3979 after 6 init + 20 suggestions, every suggestion in the
    box; on the JAX test's draws, which the committed file holds."""
    want = branin_jax_draws()
    with np.load(BRANIN_DRAWS) as f:
        stored = dict(f)
    assert sorted(stored) == sorted(want)
    for k in want:
        close(stored[k], want[k], rtol=0)
    lower, upper = torch.tensor([-5.0, 0.0]), torch.tensor([10.0, 15.0])
    design = tbo.DesignDraws(torch.tensor(stored["design_jitter"]), torch.tensor(stored["design_order"]))
    state, x_init = tbo.bo_init(lower, upper, capacity=26, num_init=6, draws=design)
    for i in range(6):
        state = tbo.bo_observe(state, x_init[i], _branin(x_init[i].double().numpy()))
    cfg = tbo.BayesOptConfig(num_candidates=256, hyper_steps=6)
    for i in range(20):
        state, x_next = tbo.bo_suggest(state, tbo.BODraws(*(torch.tensor(stored[k][i]) for k in tbo.BODraws._fields)),
                                       cfg)
        assert bool((x_next >= lower - 1e-6).all() & (x_next <= upper + 1e-6).all())
        state = tbo.bo_observe(state, x_next, _branin(x_next.double().numpy()))
    _, y_best = state.best(minimize=True)
    assert state.n == 26 and float(y_best) < 0.3979 + 0.7


def _camel(x):
    x1, x2 = x[0], x[1]
    return (4.0 - 2.1 * x1**2 + x1**4 / 3.0) * x1**2 + x1 * x2 + (-4.0 + 4.0 * x2**2) * x2**2


def test_pinned_nugget_on_deterministic_objective():
    """Six-Hump Camel with the surrogate noise pinned (nugget 1e-6): 8 + 28
    evaluations reach within 0.05 of the global optimum -1.0316."""
    cfg = tbo.BayesOptConfig(nugget=1e-6)
    res = tbo.bayes_optimize(_camel, torch.tensor([-2.0, -1.0]), torch.tensor([2.0, 1.0]), num_steps=28, num_init=8,
                             config=cfg, draws=_jax_run_draws(jax.random.PRNGKey(0), cfg, 2, 8, 28))
    assert float(res.y_best) < -1.0316 + 0.05


def test_maximize_convention():
    cfg = tbo.BayesOptConfig(minimize=False, num_candidates=128, hyper_steps=4)
    res = tbo.bayes_optimize(lambda x: -torch.sum(x**2) + 2.0, torch.tensor([-1.0]), torch.tensor([1.0]),
                             num_steps=10, num_init=6, config=cfg,
                             draws=_jax_run_draws(jax.random.PRNGKey(11), cfg, 1, 6, 10))
    assert float(res.y_best) > 1.95
    close(float(res.y_best), float(torch.max(res.y_history)), rtol=1e-6)


@pytest.mark.parametrize("acq", ["ucb", "thompson"])
def test_acquisition_variants_run(acq):
    cfg = tbo.BayesOptConfig(acquisition=acq, num_candidates=96, hyper_steps=3)
    res = tbo.bayes_optimize(lambda x: torch.sum(x**2), torch.tensor([-1.0, -1.0]), torch.tensor([1.0, 1.0]),
                             num_steps=6, num_init=5, config=cfg,
                             draws=_jax_run_draws(jax.random.PRNGKey(5), cfg, 2, 5, 6))
    assert np.isfinite(float(res.y_best))


def test_bo_init_validation_and_design():
    with pytest.raises(ValueError):
        tbo.bo_init(torch.zeros(2), torch.ones(2), capacity=4, num_init=6)
    with pytest.raises(ValueError):
        tbo.bo_init(torch.zeros(2), torch.ones(2), capacity=8, num_init=1)
    # the design from the JAX draws is the JAX design
    jstate, jx = jbo.bo_init(jnp.asarray([-1.0, 0.0, 2.0]), jnp.asarray([1.0, 5.0, 3.0]), 9, jax.random.PRNGKey(4),
                             num_init=7, dtype=jnp.float64)
    tstate, tx = tbo.bo_init(T([-1.0, 0.0, 2.0]), T([1.0, 5.0, 3.0]), 9, num_init=7, dtype=torch.float64,
                             draws=_jax_design(jax.random.PRNGKey(4), 7, 3))
    close(tx, jx, rtol=1e-15)
    close(tstate.log_ell, jstate.log_ell, rtol=0)
    # each column of a design holds one point per stratum
    _, x = tbo.bo_init(torch.zeros(2), torch.ones(2), capacity=10, num_init=10, device="cpu")
    assert sorted(torch.floor(x[:, 0] * 10).int().tolist()) == list(range(10))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbo.bo_init([0.0, 0.0], [1.0, 1.0], capacity=4, num_init=2)


if __name__ == "__main__":
    BRANIN_DRAWS.parent.mkdir(exist_ok=True)
    np.savez_compressed(BRANIN_DRAWS, **branin_jax_draws())
    print(f"wrote {BRANIN_DRAWS}")
