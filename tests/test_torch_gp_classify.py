"""The port's latent-GP classifier (Laplace, EP, elliptical slice) against
the JAX package, on the CPU, float64.

Two kinds of test: parity tests put the same numpy-seeded inputs through
both packages, and oracle tests hold the port to the oracles of the JAX
package's own tests (``tests/test_gp_classify.py``, ``test_gp_ep.py``,
``test_ess.py``), one counterpart each, under the same names and bounds.
Parity tolerances:

* logML (Laplace and EP), latent moments, mode: rtol 1e-10;
* their gradients in theta: rtol 1e-10 of the largest entry;
* Newton steps and EP sweeps: exactly the JAX loop's count on each lane;
* a batch of three (one absurd lane) against the three calls alone: rtol
  1e-12, and the log-zero sentinel on the absurd lane;
* the classifier's Hessian in theta against ``jax.hessian``: rtol 1e-6 of
  its largest entry;
* ESS draws, replaying the JAX key tree: 1e-10 of the largest |draw|,
  draw for draw;
* Adam traces of ``optimize_gp_classifier`` over 50 steps: rtol 1e-9;
* the likelihoods' derivatives d1-d3 (closed forms and autodiff) against
  nested ``jax.grad``: rtol 1e-10 (atol 1e-13);
* the Laplace fit of a classifier problem: ``test_torch_laplace.py``'s
  bounds (mode 1e-6, logZ 1e-6 absolute, precision 1e-5 of its largest
  entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import gp_classify as jgc
from bayesianinference_tpu.engines import laplace as jl
from bayesianinference_tpu.ops import ess as jess
from bayesianinference_tpu.ops import gp_ep as jep
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.ops import gp_laplace as jla
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import gp_classify as tgc
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.interop import gp_classifier_optimization_from_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops import ess as tess
from bayesianinference_tpu_torch.ops import gp_ep as tep
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.ops import gp_laplace as tla

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    """Every entry within ``rtol`` of the largest |want|."""
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


LIKS = ["bernoulli_logit", "bernoulli_probit", "poisson_log"]


def liks(name):
    return getattr(jla, f"{name}_likelihood")(), getattr(tla, f"{name}_likelihood")()


def _toy(n=14, seed=0, counts=False):
    """``tests/test_gp_classify.py::_toy`` as numpy: x [n, 1], y, K."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    k = np.asarray(jgk.covariance_matrix(jgk.se_kernel(2.0, 1.0), jnp.asarray(x), 1e-8))
    f = np.linalg.cholesky(k) @ rng.normal(size=n)
    y = rng.poisson(np.exp(f)).astype(float) if counts else (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)
    return x, y, k


def _class_data(n=40, seed=5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    return x, (rng.uniform(size=n) < p).astype(float)


_PARAMS = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]


def _problems(x, y, likelihood="bernoulli_logit", method="laplace"):
    jp = jgc.define_gp_classifier(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]),
                                  _PARAMS, likelihood=likelihood, method=method, prior_distribution=["scale"] * 2,
                                  validate=False)
    tp = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                  likelihood=likelihood, method=method, prior_distribution=["scale"] * 2,
                                  validate=False)
    return jp, tp


def _jax_newton_count(k, y, lik, maxiter=50, tol=1e-8):
    """The JAX package's Newton ``while_loop`` stepped on the host with its
    own ``_newton_state``: (f_hat, a, steps)."""
    n = y.shape[0]
    step = jax.jit(lambda f: jla._newton_state(k, y, lik, f, jnp.eye(n)))
    f, a, delta, it = jnp.zeros(n), jnp.zeros(n), np.inf, 0
    while it < maxiter and delta > tol:
        f_new, _, _, _, a = step(f)
        delta = float(jnp.max(jnp.abs(f_new - f)))
        delta = 0.0 if np.isnan(delta) else delta
        f, it = f_new, it + 1
    return f, a, it


# ---------------------------------------------------------------------------
# parity: likelihoods, Laplace, EP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit", "poisson_log", "negative_binomial",
                                  "gamma_log", "ordinal_logit", "binomial_logit"])
def test_likelihood_derivatives_match_jax(name):
    rng = np.random.default_rng(1)
    f = rng.normal(scale=2.0, size=12)
    args = {"negative_binomial": (3.0,), "gamma_log": (2.5,), "ordinal_logit": ([-1.0, 0.5, 2.0],)}.get(name, ())
    jlik, tlik = getattr(jla, f"{name}_likelihood")(*args), getattr(tla, f"{name}_likelihood")(*args)
    y = {"poisson_log": rng.poisson(3.0, 12), "negative_binomial": rng.poisson(3.0, 12),
         "gamma_log": rng.gamma(2.0, size=12), "ordinal_logit": rng.integers(0, 4, 12),
         "binomial_logit": np.stack([rng.integers(0, 5, 12), np.full(12, 6)], axis=-1)}.get(
        name, rng.integers(0, 2, 12)).astype(float)
    want = jlik._derivs()
    got = tlik._derivs()
    for jf, tf in zip(want, got):
        close(tf(T(f)[None], T(y))[0], jf(jnp.asarray(f), jnp.asarray(y)), rtol=1e-10, atol=1e-13)
    close(tlik.link(T(f)), jlik.link(jnp.asarray(f)), rtol=1e-12)


@pytest.mark.parametrize("name", LIKS)
@pytest.mark.parametrize("method", ["laplace", "ep"])
def test_logml_gradient_and_steps_match_jax(name, method):
    """Value, gradient in theta and the loop's step count, lane by lane."""
    jlik, tlik = liks(name)
    x, y, _ = _toy(n=30, seed=4, counts=name == "poisson_log")
    jfn = jep.gp_ep_log_marginal if method == "ep" else jla.gp_laplace_log_marginal
    tfn = tep.gp_ep_log_marginal if method == "ep" else tla.gp_laplace_log_marginal

    def jf(th):
        return jfn(jgk.covariance_matrix(jgk.se_kernel(th[0] ** 2, th[1]), jnp.asarray(x), 1e-6), jnp.asarray(y), jlik)

    def tf(th):
        return tfn(tgk.covariance_matrix(tgk.se_kernel(th[0] ** 2, th[1]), T(x), 1e-6), T(y), tlik)

    jvg = jax.jit(jax.value_and_grad(jf))
    for th in ([1.5, 0.8], [0.7, 2.0]):
        th_t = T(th).requires_grad_(True)
        value = tf(th_t)
        (grad,) = torch.autograd.grad(value, th_t)
        want, want_grad = jvg(jnp.asarray(th))
        close(value.detach(), want, rtol=1e-10)
        close_rel(grad, want_grad, 1e-10)
        kj = jgk.covariance_matrix(jgk.se_kernel(th[0] ** 2, th[1]), jnp.asarray(x), 1e-6)
        kt = T(np.asarray(kj))[None]
        if method == "laplace":
            f_j, a_j, steps = _jax_newton_count(kj, jnp.asarray(y), jlik)
            res = tla._newton_loop(kt, T(y), tlik._derivs(), 50, 1e-8)
            assert int(res.iterations[0]) == steps
            close(res.f[0], f_j, rtol=1e-10, atol=1e-12)
            close(res.a[0], a_j, rtol=1e-10, atol=1e-12)
        else:
            st = tep.gp_ep_state(kt, T(y), tlik)
            want = jep.gp_ep_state(kj, jnp.asarray(y), jlik)
            assert int(st.iterations[0]) == int(want.iterations)
            for g, w in zip(st[:4], want[:4]):
                close(g[0], w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("method", ["laplace", "ep"])
def test_batched_call_equals_unbatched_with_an_absurd_lane(method):
    """B = 3 through the problem: each lane equals its own call and the
    JAX value, steps included; the NaN lane gives the log-zero sentinel."""
    x, y = _class_data(n=30)
    jp, tp = _problems(x, y, method=method)
    thetas = np.array([[1.5, 1.0], [np.nan, 1.0], [0.5, 0.4]])
    got = tp.guarded_log_likelihood(T(thetas))
    singles = torch.stack([tp.guarded_log_likelihood(T(th)) for th in thetas])
    close(got, singles, rtol=1e-12)
    assert bool(is_log_zero(got[1])) and not bool(is_log_zero(got[[0, 2]]).any())
    want = jax.vmap(jp.log_likelihood)(jnp.asarray(thetas))
    close(got[[0, 2]], np.asarray(want)[[0, 2]], rtol=1e-10)
    model = tp.metadata["gp_classifier"]
    k = model._k_batch(T(thetas))
    if method == "laplace":
        lanes = tla._newton_loop(k, model.y, model.likelihood._derivs(), 50, 1e-8).iterations
        alone = [int(tla._newton_loop(k[i:i + 1], model.y, model.likelihood._derivs(), 50, 1e-8).iterations[0])
                 for i in range(3)]
    else:
        lanes = tep.gp_ep_state(k, model.y, model.likelihood).iterations
        alone = [int(tep.gp_ep_state(k[i], model.y, model.likelihood).iterations) for i in range(3)]
    assert lanes.tolist() == alone


def test_classifier_hessian_matches_jax_hessian():
    x, y = _class_data(n=40)
    jp, tp = _problems(x, y)
    th = np.array([1.7, 0.9])
    want = np.asarray(jax.jit(jax.hessian(jp.log_likelihood))(jnp.asarray(th)))
    got = torch.autograd.functional.hessian(tp.log_likelihood, T(th))
    close_rel(got, want, 1e-6)


def test_laplace_fit_of_the_classifier_matches_jax():
    x, y = _class_data(n=40)
    jp, tp = _problems(x, y)
    starts = np.array([[1.0, 1.0], [3.0, 0.5], [0.5, 2.0]])
    want = jl.laplace_posterior_fit(problem=jp, initial_guess=jnp.asarray(starts))
    got = tl.laplace_posterior_fit(problem=tp, initial_guess=T(starts))
    close(got.mean, want.mean, rtol=1e-6, atol=1e-8)
    close(got.log_evidence, want.log_evidence, rtol=0, atol=1e-6)
    p_want = np.asarray(want.precision_matrix)
    close(got.precision_matrix, p_want, rtol=0, atol=1e-5 * np.abs(p_want).max())


@pytest.mark.parametrize("method", ["laplace", "ep"])
def test_predictions_and_latent_moments_match_jax(method):
    x, y = _class_data(n=30)
    jp, tp = _problems(x, y, method=method)
    xq = np.linspace(-3, 3, 9)[:, None]
    draws = np.array([[1.7, 0.9], [1.2, 1.1], [2.0, 0.7]])
    want = jgc.predict_from_gp_classifier(jnp.asarray(draws), jp, jnp.asarray(xq))
    got = tgc.predict_from_gp_classifier(T(draws), tp, T(xq))
    close(got.mean, want.mean, rtol=1e-10)
    close(got.latent.component.loc, want.latent.component.loc, rtol=1e-10, atol=1e-12)
    close(got.latent.component.scale, want.latent.component.scale, rtol=1e-10)


def test_adam_trace_matches_optax():
    x, y = _class_data(n=30)
    jp, tp = _problems(x, y)
    want = jgc.optimize_gp_classifier(jp, steps=50, learning_rate=0.1)
    got = tgc.optimize_gp_classifier(tp, steps=50, learning_rate=0.1)
    close(got.trace, want.trace, rtol=1e-9)
    close(got.theta, want.theta, rtol=1e-9)
    close(got.log_marginal, want.log_marginal, rtol=1e-9)
    # the JAX fit handed to the port: its theta gives the port's logML the JAX value
    fit = gp_classifier_optimization_from_numpy({k: np.asarray(getattr(want, k)) for k in
                                                 ("theta", "log_marginal", "trace")}, device="cpu")
    assert fit.theta.dtype == torch.float64 and fit.trace.shape == (50,)
    close(tp.log_likelihood(fit.theta), want.log_marginal, rtol=1e-10)


# ---------------------------------------------------------------------------
# parity: elliptical slice sampling, replaying the JAX key tree
# ---------------------------------------------------------------------------


def _jax_update_draws(keys, n, max_shrink, dtype=jnp.float64):
    """The draws of ``ops/ess.py::ess_update`` under each key of ``keys``
    [..., 2]: (normal, level, angle, shrink) as [0, 1) uniforms."""

    def one(key):
        k_nu, k_level, k_theta, k_shrink = jax.random.split(key, 4)

        def step(kk, _):
            kk, sub = jax.random.split(kk)
            return kk, jax.random.uniform(sub, (), dtype)

        _, shrink = jax.lax.scan(step, k_shrink, None, length=max_shrink)
        return (jax.random.normal(k_nu, (n,), dtype), jax.random.uniform(k_level, (), dtype),
                jax.random.uniform(k_theta, (), dtype), shrink)

    flat = keys.reshape(-1, keys.shape[-1])
    out = jax.jit(jax.vmap(one))(flat)
    return [np.asarray(o).reshape(keys.shape[:-1] + o.shape[1:]) for o in out]


def _jax_latent_draws(key, num_chains, n, burn_in, num_samples, thin, max_shrink):
    """``sample_gp_latents``'s key tree as a port ``GPLatentDraws``."""
    init, updates = [], []
    for chain_key in jax.random.split(key, num_chains):
        k_init, k_run = jax.random.split(chain_key)
        init.append(np.asarray(jax.random.normal(k_init, (n,), jnp.float64)))
        k_burn, k_coll = jax.random.split(k_run)
        keys = [jax.random.split(k_burn, burn_in)] + [jax.random.split(k, thin) for k in
                                                      jax.random.split(k_coll, num_samples)]
        updates.append(_jax_update_draws(jnp.concatenate(keys), n, max_shrink))
    stacked = [T(np.stack([u[i] for u in updates], axis=1)) for i in range(4)]
    return tgc.GPLatentDraws(init=T(np.stack(init)), updates=tess.ESSDraws(*stacked))


def test_sample_gp_latents_matches_jax_draw_for_draw():
    rng = np.random.default_rng(11)
    n = 10
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    y = (rng.uniform(size=n) < 0.5).astype(float)
    kwargs = dict(likelihood="bernoulli_logit", validate=False)
    jp = jgc.define_gp_classifier(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0], th[1]),
                                  [("ell", 0.1, 10.0), ("amp", 0.1, 10.0)], **kwargs)
    tp = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0], th[1]),
                                  [("ell", 0.1, 10.0), ("amp", 0.1, 10.0)], **kwargs)
    theta, chains, samples, burn, thin, shrink = np.array([1.0, 1.0]), 4, 16, 16, 2, 64
    key = jax.random.PRNGKey(3)
    want = jgc.sample_gp_latents(key, jp, jnp.asarray(theta), samples, num_chains=chains, burn_in=burn, thin=thin,
                                 max_shrink=shrink)
    draws = _jax_latent_draws(key, chains, n, burn, samples, thin, shrink)
    got = tgc.sample_gp_latents(None, tp, T(theta), samples, num_chains=chains, burn_in=burn, thin=thin,
                                max_shrink=shrink, draws=draws)
    close_rel(got.draws, want.draws, 1e-10)
    close(got.log_lik, want.log_lik, rtol=1e-10)
    assert got.evals.tolist() == np.asarray(want.evals).tolist()
    assert got.moved.tolist() == np.asarray(want.moved).tolist()


def test_ess_update_replays_jax_with_a_mean_and_max_shrink():
    """One update of 5 chains with a prior mean, and a max_shrink of 2 that
    some chains hit, against the JAX update under the same keys."""
    rng = np.random.default_rng(2)
    n = 6
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    chol = np.linalg.cholesky(np.asarray(jgk.covariance_matrix(jgk.se_kernel(1.5, 1.0), jnp.asarray(x), 1e-8)))
    mean, yv = rng.normal(size=n), 3.0 * rng.normal(size=n)
    f0 = rng.normal(size=(5, n))

    def jll(f):
        return -2.0 * jnp.sum((jnp.asarray(yv) - f) ** 2)

    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    for max_shrink in (2, 64):
        want = [jess.ess_update(k, jess.ess_init(jnp.asarray(f), jll), jll, jnp.asarray(chol),
                                mean=jnp.asarray(mean), max_shrink=max_shrink) for k, f in zip(keys, f0)]
        draws = tess.ESSDraws(*(T(d) for d in _jax_update_draws(keys, n, max_shrink)))
        state = tess.ess_init(T(f0), lambda f: -2.0 * ((T(yv) - f) ** 2).sum(dim=-1))
        got = tess.ess_update(draws, state, lambda f: -2.0 * ((T(yv) - f) ** 2).sum(dim=-1), T(chol), mean=T(mean),
                              max_shrink=max_shrink)
        close(got.f, np.stack([np.asarray(w.f) for w in want]), rtol=1e-10, atol=1e-12)
        assert got.evals.tolist() == [int(w.evals) for w in want]
        assert got.moved.tolist() == [int(w.moved) for w in want]
    assert got.moved.tolist() == [1] * 5


# ---------------------------------------------------------------------------
# oracles of tests/test_gp_classify.py
# ---------------------------------------------------------------------------


def _exact_latent_logpost(k, y, lpf):
    """psi(f) = log p(y|f) + log N(f; 0, K)."""
    n = y.shape[0]
    ell = torch.linalg.cholesky(k)
    logdet = 2.0 * torch.log(torch.diagonal(ell)).sum()

    def psi(f):
        z = torch.linalg.solve_triangular(ell, f[:, None], upper=False)[:, 0]
        return lpf(f[None], y)[0].sum() - 0.5 * (z * z).sum() - 0.5 * (logdet + n * np.log(2 * np.pi))

    return psi


@pytest.mark.parametrize("name", LIKS)
def test_newton_mode_matches_direct_optimization(name):
    _, lik = liks(name)
    _, y, k = _toy(counts=name == "poisson_log")
    k, y = T(k), T(y)
    f_hat, a = tla.gp_laplace_mode(k, y, lik)
    ell = torch.linalg.cholesky(k)
    lpf = lik._derivs()[0]

    def psi_u(u):
        return lpf((ell @ u)[None], y)[0].sum() - 0.5 * (u * u).sum()

    u_opt, _ = tl.find_mode(psi_u, torch.zeros((1, y.shape[0]), dtype=torch.float64), maxiter=2000)
    close(f_hat, ell @ u_opt, rtol=0, atol=1e-6)
    close(k @ a, f_hat, rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", LIKS)
def test_logml_matches_generic_laplace_evidence(name):
    _, lik = liks(name)
    _, y, k = _toy(seed=1, counts=name == "poisson_log")
    k, y = T(k), T(y)
    logz = float(tla.gp_laplace_log_marginal(k, y, lik))
    lpf, _, d2f, _ = lik._derivs()
    f_hat, _ = tla.gp_laplace_mode(k, y, lik)
    w = -d2f(f_hat[None], y)[0]
    precision = torch.linalg.inv(k) + torch.diag(w)
    logz_generic = float(tl.laplace_log_evidence(_exact_latent_logpost(k, y, lpf)(f_hat), precision))
    close(logz, logz_generic, rtol=1e-7)


@pytest.mark.parametrize("name", LIKS)
def test_hyperparameter_gradient_matches_finite_differences(name):
    _, lik = liks(name)
    x, y, _ = _toy(seed=2, counts=name == "poisson_log")
    x, y = T(x), T(y)

    def logml(theta):
        k = tgk.covariance_matrix(tgk.se_kernel(torch.exp(theta[0]), torch.exp(theta[1])), x, 1e-8)
        return tla.gp_laplace_log_marginal(k, y, lik)

    theta0 = T([0.4, -0.3]).requires_grad_(True)
    (g,) = torch.autograd.grad(logml(theta0), theta0)
    eps = 1e-6
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[i] = eps
            fd = (float(logml(theta0 + e)) - float(logml(theta0 - e))) / (2 * eps)
            close(float(g[i]), fd, rtol=2e-5, atol=1e-8)


def _exact_logz_gh(k, y, lik, order=60):
    """Exact marginal at n = 3 by tensor Gauss-Hermite over f ~ N(0, K)."""
    from scipy.special import logsumexp

    nodes, weights = np.polynomial.hermite_e.hermegauss(order)
    ell = np.linalg.cholesky(np.asarray(k))
    g1, g2, g3 = np.meshgrid(nodes, nodes, nodes, indexing="ij")
    fs = np.stack([g1.ravel(), g2.ravel(), g3.ravel()], axis=-1) @ ell.T
    lw = np.log(weights) - 0.5 * np.log(2 * np.pi)
    iw = np.add.outer(np.add.outer(lw, lw), lw).ravel()
    ll = lik._derivs()[0](T(fs), T(y)).sum(dim=-1).numpy()
    return logsumexp(iw + ll) - 3 * logsumexp(lw)


_TINY_X = np.array([[-1.0], [0.2], [1.4]])


def _tiny_k(var):
    return tgk.covariance_matrix(tgk.se_kernel(var, 1.0), T(_TINY_X), 1e-8)


def test_logml_near_exact_marginal_tiny_n():
    _, lik = liks("bernoulli_logit")
    y = T([0.0, 1.0, 1.0])
    k = _tiny_k(1.5)
    assert abs(float(tla.gp_laplace_log_marginal(k, y, lik)) - _exact_logz_gh(k, y, lik)) < 0.05


def test_latent_moments_match_dense_formulas():
    _, lik = liks("bernoulli_logit")
    x, y, k = _toy(seed=3)
    x, y, k = T(x), T(y), T(k)
    xq = T([[-2.5], [0.1], [2.2]])
    kern = tgk.se_kernel(2.0, 1.0)
    kc, kqd = kern.matrix(x, xq), kern.diag(xq) + 1e-8
    mu, var = tla.gp_laplace_latent_moments(k, y, lik, kc, kqd)
    f_hat, a = tla.gp_laplace_mode(k, y, lik)
    w = np.diag(-lik._derivs()[2](f_hat[None], y)[0].numpy())
    kn, kcn = k.numpy(), kc.numpy()
    cov = np.linalg.inv(kn + np.linalg.inv(w))
    close(mu, kcn.T @ a.numpy(), rtol=0, atol=1e-9)
    close(var, kqd.numpy() - np.diag(kcn.T @ cov @ kcn), rtol=0, atol=1e-9)


def test_gauss_hermite_expectation_exact_for_polynomials():
    mu, var = T([0.5, -1.0]), T([2.0, 0.3])
    close(tla.gauss_hermite_expectation(lambda f: f**2, mu, var, 16), mu**2 + var, rtol=1e-12)
    zs = np.linspace(-10, 10, 20001)
    for m, v in [(0.5, 2.0), (-1.0, 0.3)]:
        dens = np.exp(-0.5 * (zs - m) ** 2 / v) / np.sqrt(2 * np.pi * v)
        ref = np.trapezoid(dens / (1 + np.exp(-zs)), zs)
        close(float(tla.gauss_hermite_expectation(torch.sigmoid, T(m), T(v))), ref, rtol=1e-8)


@pytest.fixture(scope="module")
def classify_problem():
    rng = np.random.default_rng(5)
    n = 60
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    y = (rng.uniform(size=n) < p).astype(float)
    problem = tgc.define_gp_classifier(x, y, lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                       prior_distribution=["scale", "scale"], validate=False, device="cpu")
    return problem, x, y


def test_problem_batch_and_sentinel(classify_problem):
    problem, _, _ = classify_problem
    vals = problem.guarded_log_likelihood(T([[1.5, 1.0], [0.5, 0.4], [3.0, 2.0]]))
    assert vals.shape == (3,) and bool(torch.isfinite(vals).all())
    assert bool(is_log_zero(problem.guarded_log_likelihood(T([1.0, np.nan]))))


def test_end_to_end_laplace_fit_and_prediction(classify_problem):
    problem, _, _ = classify_problem
    fit = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(fit.log_evidence))
    xq = np.linspace(-3, 3, 41)[:, None]
    pred = tgc.predict_from_gp_classifier(fit.mean, problem, xq)
    p = pred.mean.numpy()
    assert p.shape == (41,) and np.all((p >= 0) & (p <= 1))
    assert pred.latent.quantile(0.9).shape == (41,)
    p_true = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * xq[:, 0])))
    assert np.corrcoef(p, p_true)[0, 1] > 0.85
    noise = torch.randn((8, 2), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    draws = fit.mean[None, :] + 0.01 * noise
    pred2 = tgc.predict_from_gp_classifier(draws, problem, xq)
    assert pred2.mean.shape == (41,)
    close(pred2.mean, p, rtol=0, atol=0.1)


def test_type_ii_ml_fit_improves_and_matches_gridded_optimum(classify_problem):
    problem, _, _ = classify_problem
    opt = tgc.optimize_gp_classifier(problem, steps=150, learning_rate=0.1)
    assert bool((opt.theta > problem.lower).all()) and bool((opt.theta < problem.upper).all())
    assert float(opt.log_marginal) > float(opt.trace[0])
    th = opt.theta.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(problem.log_likelihood(th), th)
    assert float(g.abs().max()) < 0.3
    grid = T([[a, ls] for a in np.linspace(0.3, 4.0, 10) for ls in np.linspace(0.2, 3.0, 10)])
    assert float(opt.log_marginal) >= float(problem.log_likelihood(grid).max()) - 0.1
    with pytest.raises(ValueError, match="define_gp_classifier"):
        tgc.optimize_gp_classifier(define_inference_problem(parameters=[("a", 0.0, 1.0)],
                                                            log_likelihood=lambda th: -torch.sum(th**2),
                                                            validate=False, device="cpu"))


def test_poisson_count_regression_end_to_end():
    rng = np.random.default_rng(9)
    n = 50
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    rate = np.exp(1.0 + np.sin(2.0 * x[:, 0]))
    y = rng.poisson(rate).astype(float)
    problem = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                       likelihood="poisson_log", prior_distribution=["scale", "scale"],
                                       validate=False)
    fit = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    pred = tgc.predict_from_gp_classifier(fit.mean, problem, T(x))
    assert np.corrcoef(pred.mean.numpy(), rate)[0, 1] > 0.9


def test_negative_binomial_likelihood_tiny_n_and_scipy():
    from scipy.stats import nbinom

    lik = tla.negative_binomial_likelihood(3.0)
    for f, y in [(0.3, 2.0), (-1.0, 0.0), (1.2, 7.0)]:
        ref = nbinom.logpmf(int(y), 3.0, 3.0 / (3.0 + np.exp(f)))
        close(float(lik.log_prob(T(f), T(y))), ref, rtol=1e-10)
    d2 = lik._derivs()[2]
    assert bool((d2(T([-2.0, 0.0, 2.0])[None], T([5.0, 5.0, 5.0]))[0] < 0).all())
    with pytest.raises(ValueError, match="dispersion"):
        tla.negative_binomial_likelihood(-1.0)
    y = T([0.0, 2.0, 5.0])
    k = _tiny_k(1.2)
    assert abs(float(tla.gp_laplace_log_marginal(k, y, lik)) - _exact_logz_gh(k, y, lik)) < 0.05


def test_binomial_counts_end_to_end():
    rng = np.random.default_rng(11)
    n = 40
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    p = 1 / (1 + np.exp(-2.0 * np.sin(2.0 * x[:, 0])))
    trials = rng.integers(5, 20, size=n)
    y = np.stack([rng.binomial(trials, p), trials], axis=-1).astype(float)
    problem = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                       likelihood="binomial_logit", prior_distribution=["scale", "scale"],
                                       validate=False)
    assert np.isfinite(float(problem.log_likelihood(T([1.5, 0.8]))))
    pred = tgc.predict_from_gp_classifier(T([1.5, 0.8]), problem, T(x))
    assert np.corrcoef(pred.mean.numpy(), p)[0, 1] > 0.9
    bad = y.copy()
    bad[0, 0] = bad[0, 1] + 1
    with pytest.raises(ValueError, match="successes"):
        tgc.define_gp_classifier(T(x), T(bad), lambda th: tgk.se_kernel(1.0, th[0]), [("ls", 0.1, 5.0)],
                                 likelihood="binomial_logit", validate=False)


def test_bernoulli_target_validation():
    with pytest.raises(ValueError, match="y in"):
        tgc.define_gp_classifier(np.zeros((3, 1)), np.asarray([0.0, 2.0, 1.0]), lambda th: tgk.se_kernel(1.0, th[0]),
                                 [("ls", 0.1, 5.0)], validate=False, device="cpu")
    with pytest.raises(ValueError, match="unknown likelihood"):
        tgc.define_gp_classifier(np.zeros((3, 1)), np.asarray([0.0, 1.0, 1.0]), lambda th: tgk.se_kernel(1.0, th[0]),
                                 [("ls", 0.1, 5.0)], likelihood="nope", validate=False, device="cpu")


def test_gamma_likelihood_scipy_parity_and_fit():
    from scipy.stats import gamma as sp_gamma

    lik = tla.gamma_log_likelihood(2.5)
    for f, y in [(0.3, 2.0), (-1.0, 0.2), (1.2, 7.0)]:
        close(float(lik.log_prob(T(f), T(y))), sp_gamma.logpdf(y, 2.5, scale=np.exp(f) / 2.5), rtol=1e-10)
    assert float(lik._derivs()[2](T([0.5])[None], T([2.0]))[0, 0]) < 0
    with pytest.raises(ValueError, match="shape"):
        tla.gamma_log_likelihood(0.0)
    rng = np.random.default_rng(13)
    n = 40
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    mean_true = np.exp(0.8 * np.sin(1.5 * x[:, 0]))
    y = rng.gamma(2.5, mean_true / 2.5)
    problem = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                       likelihood=lik, prior_distribution=["scale", "scale"], validate=False)
    pred = tgc.predict_from_gp_classifier(T([0.9, 0.9]), problem, T(x))
    assert np.corrcoef(pred.mean.numpy(), mean_true)[0, 1] > 0.8


def test_ordinal_likelihood_probabilities_and_fit():
    from scipy.special import expit

    c = np.asarray([-1.0, 0.5, 2.0])
    lik = tla.ordinal_logit_likelihood(c)
    for f in (-2.0, 0.3, 3.0):
        probs_ref = np.diff(np.concatenate([[0.0], expit(c - f), [1.0]]))
        lps = np.asarray([float(lik.log_prob(T(f), T(float(k)))) for k in range(4)])
        close(np.exp(lps), probs_ref, rtol=1e-6)
        close(np.exp(lps).sum(), 1.0, rtol=1e-9)
        close(float(lik.link(T(f))), (probs_ref * np.arange(4)).sum(), rtol=1e-6)
    d2 = lik._derivs()[2]
    fs = T(np.repeat([-1.5, 0.0, 1.5], 4))
    assert bool((d2(fs[None], T(np.tile([0.0, 1.0, 2.0, 3.0], 3)))[0] <= 1e-10).all())
    with pytest.raises(ValueError, match="increasing"):
        tla.ordinal_logit_likelihood([0.0, 0.0])
    rng = np.random.default_rng(17)
    n = 50
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    f_true = 2.0 * np.sin(1.3 * x[:, 0])
    cum = expit(c[None, :] - f_true[:, None])
    y = (rng.uniform(size=n)[:, None] > cum).sum(axis=1).astype(float)
    problem = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                       likelihood=lik, prior_distribution=["scale", "scale"], validate=False)
    assert np.isfinite(float(problem.log_likelihood(T([1.5, 0.9]))))
    pred = tgc.predict_from_gp_classifier(T([1.8, 0.9]), problem, T(x))
    assert np.corrcoef(pred.mean.numpy(), f_true)[0, 1] > 0.9


# ---------------------------------------------------------------------------
# oracles of tests/test_gp_ep.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LIKS[:2])
def test_ep_logz_beats_laplace_near_exact_tiny_n(name):
    _, lik = liks(name)
    y, k = T([0.0, 1.0, 1.0]), _tiny_k(1.5)
    exact = _exact_logz_gh(k, y, lik)
    ep = float(tep.gp_ep_log_marginal(k, y, lik))
    lap = float(tla.gp_laplace_log_marginal(k, y, lik))
    assert abs(ep - exact) < 0.01 and abs(ep - exact) < abs(lap - exact), (ep, lap, exact)


def test_ep_logz_poisson_tiny_n():
    _, lik = liks("poisson_log")
    y, k = T([0.0, 2.0, 4.0]), _tiny_k(1.2)
    assert abs(float(tep.gp_ep_log_marginal(k, y, lik)) - _exact_logz_gh(k, y, lik)) < 0.03


@pytest.mark.parametrize("name", LIKS)
def test_ep_posterior_matches_dense_formulas(name):
    _, lik = liks(name)
    _, y, k = _toy(seed=1, counts=name == "poisson_log")
    state = tep.gp_ep_state(T(k), T(y), lik)
    cov = np.linalg.inv(np.linalg.inv(k) + np.diag(state.tau.numpy()))
    close(state.mu, cov @ state.nu.numpy(), rtol=0, atol=1e-8)
    close(state.sigma2, np.diag(cov), rtol=0, atol=1e-8)


def test_ep_fixed_point_moment_matching():
    _, lik = liks("bernoulli_logit")
    _, y, k = _toy(seed=2)
    state = tep.gp_ep_state(T(k), T(y), lik, maxiter=200, tol=1e-12)
    mu, s2, tau, nu = (t.numpy() for t in (state.mu, state.sigma2, state.tau, state.nu))
    tau_cav, nu_cav = 1.0 / s2 - tau, mu / s2 - nu
    mu_cav, s2_cav = nu_cav / tau_cav, 1.0 / tau_cav
    zs = np.linspace(-12, 12, 40001)
    lpf = lik._derivs()[0]
    for i in range(y.shape[0]):
        f = mu_cav[i] + np.sqrt(s2_cav[i]) * zs
        dens = np.exp(lpf(T(f)[:, None], T(y[i:i + 1]))[:, 0].numpy() - 0.5 * zs**2)
        z0 = np.trapezoid(dens, f)
        m1 = np.trapezoid(f * dens, f) / z0
        m2 = np.trapezoid(f**2 * dens, f) / z0
        close(mu[i], m1, rtol=0, atol=5e-6)
        close(s2[i], m2 - m1**2, rtol=0, atol=5e-6)


@pytest.mark.parametrize("name", LIKS)
def test_ep_hyperparameter_gradient_matches_finite_differences(name):
    _, lik = liks(name)
    x, y, _ = _toy(seed=3, counts=name == "poisson_log")
    x, y = T(x), T(y)

    def logml(theta):
        k = tgk.covariance_matrix(tgk.se_kernel(torch.exp(theta[0]), torch.exp(theta[1])), x, 1e-8)
        return tep.gp_ep_log_marginal(k, y, lik, maxiter=200, tol=1e-13)

    theta0 = T([0.4, -0.3]).requires_grad_(True)
    (g,) = torch.autograd.grad(logml(theta0), theta0)
    eps = 1e-5
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[i] = eps
            fd = (float(logml(theta0 + e)) - float(logml(theta0 - e))) / (2 * eps)
            close(float(g[i]), fd, rtol=5e-4, atol=1e-7)


def test_ep_latent_moments_match_dense_formulas():
    _, lik = liks("bernoulli_probit")
    x, y, k = _toy(seed=4)
    x, y, kt = T(x), T(y), T(k)
    xq = T([[-2.5], [0.1], [2.2]])
    kern = tgk.se_kernel(2.0, 1.0)
    kc, kqd = kern.matrix(x, xq), kern.diag(xq) + 1e-8
    mu, var = tep.gp_ep_latent_moments(kt, y, lik, kc, kqd)
    state = tep.gp_ep_state(kt, y, lik)
    s_inv = np.diag(1.0 / state.tau.numpy())
    a = np.linalg.solve(k + s_inv, state.nu.numpy() / state.tau.numpy())
    kcn = kc.numpy()
    close(mu, kcn.T @ a, rtol=0, atol=1e-7)
    close(var, kqd.numpy() - np.diag(kcn.T @ np.linalg.solve(k + s_inv, kcn)), rtol=0, atol=1e-7)


def test_classifier_surface_with_ep_method():
    rng = np.random.default_rng(5)
    n = 50
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    y = (rng.uniform(size=n) < p).astype(float)

    def build(method):
        return tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                        method=method, prior_distribution=["scale", "scale"], validate=False)

    prob_ep = build("ep")
    assert bool(is_log_zero(prob_ep.guarded_log_likelihood(T([np.nan, 1.0]))))
    assert bool(torch.isfinite(prob_ep.log_likelihood(T([[1.5, 1.0], [0.5, 0.4]]))).all())
    xq = np.linspace(-3, 3, 21)[:, None]
    pm = tgc.predict_from_gp_classifier(T([1.7, 0.8]), prob_ep, T(xq)).mean.numpy()
    assert pm.shape == (21,) and np.all((pm >= 0) & (pm <= 1))
    pl = tgc.predict_from_gp_classifier(T([1.7, 0.8]), build("laplace"), T(xq)).mean
    close(pm, pl, rtol=0, atol=0.06)
    with pytest.raises(ValueError, match="method"):
        build("nope")


# ---------------------------------------------------------------------------
# oracles of tests/test_ess.py
# ---------------------------------------------------------------------------


def _ess_setup(n=12, seed=3, sigma=0.5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    k = tgk.covariance_matrix(tgk.se_kernel(1.5, 1.0), T(x), 1e-10)
    y = torch.linalg.cholesky(k) @ T(rng.normal(size=n)) + sigma * T(rng.normal(size=n))
    return x, k, y


def _gaussian_posterior(k, y, sigma):
    k, y = k.numpy(), y.numpy()
    s = k + sigma**2 * np.eye(y.shape[0])
    return k @ np.linalg.solve(s, y), k - k @ np.linalg.solve(s, k)


def test_ess_matches_exact_gaussian_posterior():
    sigma = 0.5
    _, k, y = _ess_setup()
    mean_ex, cov_ex = _gaussian_posterior(k, y, sigma)
    chains, samples, burn, thin = 48, 192, 96, 2
    draws = tess.ess_draws(torch.Generator().manual_seed(0), chains, 12, num_updates=burn + samples * thin,
                           dtype=torch.float64)
    out, _ = tess.ess_sample(draws, torch.zeros((chains, 12), dtype=torch.float64),
                             lambda f: -0.5 * (((y - f) / sigma) ** 2).sum(dim=-1),
                             torch.linalg.cholesky(k), samples, burn_in=burn, thin=thin)
    pooled = out.reshape(-1, 12).numpy()
    sd = np.sqrt(np.diag(cov_ex))
    assert np.all(np.abs(pooled.mean(0) - mean_ex) < 0.15 * sd + 0.02)
    assert np.allclose(pooled.var(0), np.diag(cov_ex), rtol=0.25, atol=5e-3)


def test_ess_prior_invariance():
    _, k, _ = _ess_setup(n=6, seed=5)
    draws = tess.ess_draws(torch.Generator().manual_seed(1), 64, 6, num_updates=32 + 128, dtype=torch.float64)
    out, _ = tess.ess_sample(draws, torch.zeros((64, 6), dtype=torch.float64), lambda f: f.new_zeros(f.shape[0]),
                             torch.linalg.cholesky(k), 128, burn_in=32, thin=1)
    pooled = out.reshape(-1, 6).numpy()
    assert np.allclose(pooled.mean(0), 0.0, atol=0.12)
    assert np.allclose(np.cov(pooled.T), k.numpy(), rtol=0.3, atol=0.08)


def test_ess_always_moves_and_counts_evals():
    _, k, y = _ess_setup(n=8, seed=7)
    draws = tess.ess_draws(torch.Generator().manual_seed(2), 1, 8, num_updates=50, dtype=torch.float64)
    state = tess.run_ess_chain(draws, torch.zeros((1, 8), dtype=torch.float64),
                               lambda f: -0.5 * ((y[:8] - f) ** 2).sum(dim=-1),
                               torch.linalg.cholesky(k), 50)
    assert int(state.moved[0]) == 50 and int(state.evals[0]) >= 51
    assert np.isfinite(float(state.log_lik[0]))


def test_sample_gp_latents_bernoulli():
    rng = np.random.default_rng(11)
    n = 10
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    y = (rng.uniform(size=n) < 0.5).astype(float)
    problem = tgc.define_gp_classifier(T(x), T(y), lambda th: tgk.se_kernel(th[0], th[1]),
                                       [("ell", 0.1, 10.0), ("amp", 0.1, 10.0)], likelihood="bernoulli_logit",
                                       validate=False)
    theta = T([1.0, 1.0])
    out = tgc.sample_gp_latents(torch.Generator().manual_seed(3), problem, theta, 64, num_chains=8, burn_in=64,
                                thin=1)
    assert out.draws.shape == (8, 64, n)
    assert bool(torch.isfinite(out.draws).all())
    assert bool((out.moved >= 120).all())
    model = problem.metadata["gp_classifier"]
    f_hat, _ = tla.gp_laplace_mode(model._k(theta), model.y, model.likelihood, 50)
    assert np.all(np.abs(out.draws.reshape(-1, n).mean(0).numpy() - f_hat.numpy()) < 0.5)


def test_latent_draws_at_matches_gp_posterior_mean():
    sigma = 0.4
    x, k, y = _ess_setup(n=12, seed=13, sigma=sigma)
    lik = tla.latent_likelihood(lambda f, yy: -0.5 * ((yy - f) / sigma) ** 2, lambda f: f, "gauss")
    problem = tgc.define_gp_classifier(T(x), y, lambda th: tgk.se_kernel(1.5, 1.0), [("dummy", 0.1, 10.0)],
                                       likelihood=lik, jitter=1e-10, validate=False)
    theta = T([1.0])
    out = tgc.sample_gp_latents(torch.Generator().manual_seed(4), problem, theta, 128, num_chains=16, burn_in=96,
                                thin=2)
    xq = T([[-1.7], [0.3], [2.1]])
    mu_q = tgc.latent_draws_at(problem, theta, out.draws, xq)
    assert mu_q.shape == (16, 128, 3)
    k_cross = tgk.se_kernel(1.5, 1.0).matrix(T(x), xq).numpy()
    exact = k_cross.T @ np.linalg.solve(k.numpy() + sigma**2 * np.eye(12), y.numpy())
    assert np.all(np.abs(mu_q.reshape(-1, 3).mean(0).numpy() - exact) < 0.1)
    # colored joint draws: the means plus noise of the conditional spread
    # (the JAX test compares the smallest spread of fq and of mu_q, which is
    # a coin flip where the conditional sd is tiny, as at x = 2.1 here)
    fq = tgc.latent_draws_at(problem, theta, out.draws, xq, generator=torch.Generator().manual_seed(5))
    assert fq.shape == (16, 128, 3)
    kern = tgk.se_kernel(1.5, 1.0)
    cond = kern.matrix(xq, xq) - T(k_cross).mT @ torch.linalg.solve(k, T(k_cross)) + 1e-10 * torch.eye(3)
    # (at x = 2.1 the conditional variance is at the 1e-10 jitter, where its
    # cancellation error is of its own size: an absolute floor of 1e-4)
    close((fq - mu_q).std(dim=(0, 1)), torch.sqrt(torch.diagonal(cond)), rtol=0.1, atol=1e-4)


def test_entry_point_defaults_to_the_card():
    """Numpy data without ``device`` goes to the card: without one it raises."""
    x, y = _class_data(n=10)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgc.define_gp_classifier(x, y, lambda th: tgk.se_kernel(1.0, th[0]), [("ls", 0.1, 5.0)], validate=False)
