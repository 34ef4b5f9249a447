"""The port's sparse GP (collapsed Titsias bound: ``ops/sgpr.py``,
``engines/sparse_gp.py``) against the JAX package, on the CPU, float64.

Parity tests put the same numpy-seeded inputs through both packages;
oracle tests hold the port to the oracles of ``tests/test_sgpr.py``, one
counterpart each; its mesh-sharded test's counterpart holds the port's
bound on an 8-shard CPU mesh (``parallel.make_mesh``) against the JAX
bound on the 8-device mesh of ``tests/conftest.py``.  Parity tolerances:

* bound and the predictive moments: rtol 1e-10;
* the bound's gradient in theta: 1e-10 of the largest entry; its state
  (L^-1, LB^-1, c) and its gradient in z, which carry the condition number
  of K_mm: 1e-10 of the largest entry where that is below 1e6;
* farthest-point inducing selection: the same rows;
* Adam traces of ``optimize_sparse_gp`` over 50 steps: the bound and
  theta at rtol 1e-9, z at 1e-8 of its largest entry;
* the data-sharded bound and its gradient: rtol 1e-10 and 1e-8 (the JAX
  test's), against the JAX mesh run and the single-device bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import sparse_gp as jsg
from bayesianinference_tpu.engines.gp import predict_from_gaussian_process as j_predict
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.ops import sgpr as jsgpr
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.engines import sparse_gp as tsg
from bayesianinference_tpu_torch.engines.gp import predict_from_gaussian_process
from bayesianinference_tpu_torch.interop import sgpr_optimization_from_numpy
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.ops import sgpr as tsgpr

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def gp_data():
    """``tests/test_sgpr.py::gp_data``: n = 150, d = 2, sigma^2 = 0.05."""
    rng = np.random.default_rng(3)
    n, dim = 150, 2
    x = rng.normal(size=(n, dim))
    sig2 = 0.05
    kmat = np.asarray(jgk.covariance_matrix(jgk.se_kernel(variance=1.3, lengthscale=0.8), jnp.asarray(x), sig2))
    y = np.linalg.cholesky(kmat) @ rng.normal(size=n)
    return T(x), T(y), tgk.se_kernel(variance=1.3, lengthscale=0.8), sig2, T(kmat)


_PARAMS = [("v", 0.05, 20.0), ("l", 0.05, 20.0), ("s2", 1e-3, 2.0)]


def _problems(x, y, inducing, jitter=1e-10):
    kwargs = dict(nugget_builder=lambda th: th[2], inducing=inducing, prior_distribution=["scale"] * 3,
                  validate=False, jitter=jitter)
    jp = jsg.define_sparse_gaussian_process(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                            lambda th: jgk.se_kernel(variance=th[0], lengthscale=th[1]), _PARAMS,
                                            **kwargs)
    tp = tsg.define_sparse_gaussian_process(x, y, lambda th: tgk.se_kernel(variance=th[0], lengthscale=th[1]),
                                            _PARAMS, **kwargs)
    return jp, tp


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def test_farthest_point_selection_matches_jax(gp_data):
    x = gp_data[0]
    for m in (1, 12, 40):
        close(tsg.select_inducing_points(x, m), jsg.select_inducing_points(jnp.asarray(x.numpy()), m), rtol=0)


@pytest.mark.parametrize("m", [12, 40])
def test_state_bound_and_gradient_match_jax(gp_data, m):
    x, y = gp_data[:2]
    z = tsg.select_inducing_points(x, m)
    xj, yj, zj = (jnp.asarray(t.numpy()) for t in (x, y, z))

    def jf(th, zz):
        return jsgpr.sgpr_bound(jgk.se_kernel(jnp.exp(th[0]), jnp.exp(th[1])), xj, yj, zz, jnp.exp(th[2]))

    for th in ([0.3, -0.2, -2.5], [1.0, 0.5, -1.0]):
        th_t = T(th).requires_grad_(True)
        z_t = z.clone().requires_grad_(True)
        kern = tgk.se_kernel(torch.exp(th_t[0]), torch.exp(th_t[1]))
        state = tsgpr.sgpr_state(kern, x, y, z_t, torch.exp(th_t[2]))
        g_th, g_z = torch.autograd.grad(state.bound, (th_t, z_t))
        jkern = jgk.se_kernel(np.exp(th[0]), np.exp(th[1]))
        want = jsgpr.sgpr_state(jkern, xj, yj, zj, np.exp(th[2]))
        wg_th, wg_z = jax.grad(jf, argnums=(0, 1))(jnp.asarray(th), zj)
        close(state.bound.detach(), want.bound, rtol=1e-10)
        close_rel(g_th, wg_th, 1e-10)
        assert bool(state.ok) == bool(want.ok)
        # L^-1, LB^-1, c and the z-gradient carry K_mm's condition number
        # (1.7e8 at m = 40 and the second theta, where they differ at 5e-10):
        # held at 1e-10 where it is below 1e6
        if np.linalg.cond(np.asarray(jkern.matrix(zj, zj))) < 1e6:
            for got_f, want_f in zip(state[:3], want[:3]):
                close_rel(got_f.detach(), want_f, 1e-10)
            close_rel(g_z, wg_z, 1e-10)


def test_predictive_and_problem_match_jax(gp_data):
    x, y = gp_data[:2]
    jp, tp = _problems(x, y, 32)
    thetas = np.array([[1.3, 0.8, 0.05], [0.7, 1.5, 0.2]])
    close(tp.guarded_log_likelihood(T(thetas)), jax.vmap(jp.log_likelihood)(jnp.asarray(thetas)), rtol=1e-10)
    xq = np.random.default_rng(5).normal(size=(9, 2))
    got = predict_from_gaussian_process(T(thetas), tp, T(xq))
    ref = j_predict(jnp.asarray(thetas), jp, jnp.asarray(xq))
    close(got.component.loc, ref.component.loc, rtol=1e-10, atol=1e-12)
    close(got.component.scale, ref.component.scale, rtol=1e-10)


@pytest.mark.parametrize("optimize_inducing", [True, False])
def test_adam_trace_matches_optax(gp_data, optimize_inducing):
    x, y = gp_data[:2]
    jp, tp = _problems(x[:60], y[:60], 10)
    want = jsg.optimize_sparse_gp(jp, steps=50, learning_rate=0.03, optimize_inducing=optimize_inducing)
    got = tsg.optimize_sparse_gp(tp, steps=50, learning_rate=0.03, optimize_inducing=optimize_inducing)
    close(got.bound_trace, want.bound_trace, rtol=1e-9)
    close(got.theta, want.theta, rtol=1e-9)
    # the inducing inputs follow Adam's m / sqrt(v) of their gradient, which
    # scales small gradients up: 1e-8 of the largest |z|
    close_rel(got.z, want.z, 1e-8)
    close(got.bound, want.bound, rtol=1e-9)
    close(got.problem.log_likelihood(got.theta), got.bound, rtol=1e-12)
    # the JAX fit handed to the port: its problem evaluates the same bound
    fit = sgpr_optimization_from_numpy({k: np.asarray(getattr(want, k)) for k in ("theta", "z", "bound",
                                                                                    "bound_trace")}, tp)
    close(fit.problem.log_likelihood(fit.theta), want.bound, rtol=1e-10)


def test_mesh_is_not_ported(gp_data):
    """JAX's mesh type is not ported: ``mesh=`` takes the port's Mesh."""
    x, y = gp_data[:2]
    with pytest.raises(TypeError, match="takes the port's parallel.Mesh"):
        tsg.define_sparse_gaussian_process(x, y, lambda th: tgk.se_kernel(lengthscale=th[0]), [("l", 0.05, 20.0)],
                                           nugget_builder=lambda th: 0.1, inducing=8, validate=False, mesh=object())


def test_sharded_bound_matches_jax_mesh_run(gp_data):
    """``tests/test_sgpr.py::test_sharded_bound_matches_single_device``:
    n = 150 is not a multiple of 8, so the padding mask is exercised;
    gradients flow through the shards, and ``optimize_sparse_gp`` keeps the
    problem's bound sharded."""
    from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
    from bayesianinference_tpu_torch.parallel import make_mesh

    x, y = gp_data[:2]
    kwargs = dict(nugget_builder=lambda th: th[2], inducing=32, prior_distribution=["scale"] * 3, validate=False,
                  jitter=1e-10)
    jp = jsg.define_sparse_gaussian_process(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                            lambda th: jgk.se_kernel(variance=th[0], lengthscale=th[1]), _PARAMS,
                                            mesh=j_make_mesh(("data",)), **kwargs)
    tp = tsg.define_sparse_gaussian_process(x, y, lambda th: tgk.se_kernel(variance=th[0], lengthscale=th[1]),
                                            _PARAMS, mesh=make_mesh(("data",), devices=["cpu"] * 8), **kwargs)
    _, single = _problems(x, y, 32)
    th = np.array([1.3, 0.8, 0.05])
    th_t = T(th).requires_grad_(True)
    got = tp.log_likelihood(th_t)
    (g,) = torch.autograd.grad(got, th_t)
    close(got.detach(), jax.jit(jp.log_likelihood)(jnp.asarray(th)), rtol=1e-10)
    close(got.detach(), single.log_likelihood(T(th)), rtol=1e-10)
    close(g, jax.jit(jax.grad(jp.log_likelihood))(jnp.asarray(th)), rtol=1e-8)
    opt = tsg.optimize_sparse_gp(tp, steps=25, learning_rate=0.05)
    close(opt.problem.log_likelihood(opt.theta), opt.bound, rtol=1e-8)
    assert opt.problem.metadata["sgpr_mesh"][1] == "data"


# ---------------------------------------------------------------------------
# oracles of tests/test_sgpr.py
# ---------------------------------------------------------------------------


def test_bound_exact_at_full_inducing(gp_data):
    x, y, k, sig2, kmat = gp_data
    exact = float(tgk.gp_log_marginal_likelihood(kmat, y))
    close(float(tsgpr.sgpr_bound(k, x, y, x, sig2, jitter=1e-12)), exact, rtol=1e-9)


def test_bound_is_lower_bound_and_monotone(gp_data):
    x, y, k, sig2, kmat = gp_data
    exact = float(tgk.gp_log_marginal_likelihood(kmat, y))
    prev = -np.inf
    for m in (10, 40, 150):
        b = float(tsgpr.sgpr_bound(k, x, y, tsg.select_inducing_points(x, m), sig2, jitter=1e-12))
        assert b <= exact + 1e-8
        assert b >= prev - 1e-8, (m, b, prev)
        prev = b
    assert abs(prev - exact) < 1e-6 * abs(exact)


def test_predictive_matches_dense_at_full_inducing(gp_data):
    x, y, k, sig2, _ = gp_data
    xq = T(np.random.default_rng(5).normal(size=(9, 2)))
    st = tsgpr.sgpr_state(k, x, y, x, sig2, jitter=1e-12)
    m_s, s_s = tsgpr.sgpr_predict(k, st, x, xq, noise_variance=sig2)
    m_d, s_d = tgk.gp_posterior_moments(k, x, y, xq, nugget=sig2)
    close(m_s, m_d, rtol=0, atol=1e-7)
    close(s_s, s_d, rtol=0, atol=1e-7)


def test_sentinel_on_bad_hyperparameters(gp_data):
    x, y, k = gp_data[:3]
    assert bool(is_log_zero(tsgpr.sgpr_bound(k, x, y, x[::4], -0.5)))
    k_bad = tgk.se_kernel(variance=1.0, lengthscale=1e12)
    assert bool(is_log_zero(tsgpr.sgpr_bound(k_bad, x, y, x[::4], 0.05, jitter=0.0)))


def test_select_inducing_points_properties(gp_data):
    x = gp_data[0]
    z = tsg.select_inducing_points(x, 20)
    assert z.shape == (20, 2)
    assert np.unique(z.numpy(), axis=0).shape[0] == 20
    zr = tsg.select_inducing_points(x, 20, method="random", generator=torch.Generator().manual_seed(1))
    assert np.unique(zr.numpy(), axis=0).shape[0] == 20
    assert tsg.select_inducing_points(x, x.shape[0] + 5).shape == x.shape
    with pytest.raises(ValueError, match="unknown inducing selection"):
        tsg.select_inducing_points(x, 5, method="kmeanz")


def test_problem_laplace_fit_recovers_hyperparameters(gp_data):
    x, y = gp_data[:2]
    _, problem = _problems(x, y, 32)
    fit = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    v, ls, s2 = fit.mean.tolist()
    assert 0.02 < s2 < 0.15 and 0.3 < ls < 2.5, fit.mean
    thetas = fit.posterior_distribution.sample(torch.Generator().manual_seed(7), (64,))
    mix = predict_from_gaussian_process(thetas, problem, x[:40])
    resid = mix.mean().numpy() - y[:40].numpy()
    sd = np.sqrt(mix.variance().numpy())
    assert np.mean(np.abs(resid) < 2.5 * sd) > 0.85


def test_scalar_noise_enforced(gp_data):
    x, y = gp_data[:2]
    problem = tsg.define_sparse_gaussian_process(x, y, lambda th: tgk.se_kernel(lengthscale=th[0]), [("l", 0.05, 20.0)],
                                                 nugget_builder=lambda th: torch.full((3,), 0.1), inducing=16,
                                                 prior_distribution=["scale"], validate=False)
    with pytest.raises(ValueError, match="SCALAR noise variance"):
        problem.log_likelihood(T([1.0]))


def test_optimize_sparse_gp_tightens_bound(gp_data):
    x, y = gp_data[:2]
    _, problem = _problems(x, y, 12)
    opt = tsg.optimize_sparse_gp(problem, steps=250, learning_rate=0.03)
    theta = opt.theta
    kmat_opt = tgk.covariance_matrix(tgk.se_kernel(variance=theta[0], lengthscale=theta[1]), x, theta[2])
    exact_at_theta = float(tgk.gp_log_marginal_likelihood(kmat_opt, y))
    fixed_z_bound = float(problem.log_likelihood(theta))
    final = float(opt.bound)
    assert final <= exact_at_theta + 1e-6, (final, exact_at_theta)
    assert final > fixed_z_bound + 0.5, (final, fixed_z_bound)
    assert final > float(opt.bound_trace[0]) + 1.0
    close(float(opt.problem.log_likelihood(theta)), final, rtol=1e-6)
    assert opt.z.shape == (12, 2)
    v, ls, s2 = theta.tolist()
    assert 0.01 < s2 < 0.3 and 0.2 < ls < 3.0, theta


def test_optimize_fixed_inducing(gp_data):
    x, y = gp_data[:2]
    _, problem = _problems(x, y, 16, jitter=None)
    z0 = problem.metadata["gaussian_process"].z
    opt = tsg.optimize_sparse_gp(problem, steps=120, learning_rate=0.05, optimize_inducing=False)
    assert torch.equal(opt.z, z0)
    assert float(opt.bound) > float(opt.bound_trace[0])
