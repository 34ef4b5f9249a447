"""The port's GP gradient path against the JAX package, on the CPU.

On the CPU the custom ops run their plain PyTorch versions; their reverse
rules and the closed-form logML backward are the port's own code, held
here against ``jax.grad``/``jax.hessian`` of the JAX package's logML
(whose backward is its own closed form) on the same numpy-seeded inputs.
Tolerances (float64):

* logML value and gradient: rtol 1e-10 (different factorization order);
* Hessian: rtol 1e-8 of its largest entry;
* each covariance family's matrix and diagonal: rtol 1e-12 (same formula);
* the op rules against finite differences: ``gradcheck``/``gradgradcheck``
  defaults (atol 1e-5, rtol 1e-3, eps 1e-6);
* the integer query grid of ``predict_from_gaussian_process``: rtol 1e-10
  for the predictive moments;
* the SE op's float32 lengthscale gradient on data 30 lengthscales wide,
  against float64 on the same float32-rounded inputs: 1e-6 of its norm
  (the Gram form of the sum misses it by 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.engines.gp import predict_from_gaussian_process as j_predict
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process, predict_from_gaussian_process
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _data(n=30, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)


# theta = [log variance, log lengthscale(s)..., log nugget]; ARD has d lengthscales
THETA = {"iso": np.array([0.3, -0.2, -2.0]), "ard": np.array([0.3, -0.2, 0.4, 0.1, -2.0])}


def _logml_pair(x, y):
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), T(x), T(y)

    def jf(th):
        k = jgk.covariance_matrix(jgk.se_kernel(jnp.exp(th[0]), jnp.exp(th[1:-1])), xj, nugget=jnp.exp(th[-1]),
                                  symmetrize=False)
        return jgk.gp_log_marginal_likelihood(k, yj)

    def tf(th):
        k = tgk.covariance_matrix(tgk.se_kernel(torch.exp(th[0]), torch.exp(th[1:-1])), xt, nugget=torch.exp(th[-1]),
                                  symmetrize=False)
        return tgk.gp_log_marginal_likelihood(k, yt)

    return jf, tf


@pytest.mark.parametrize("form", ["iso", "ard"])
def test_logml_gradient_matches_jax_grad(form):
    jf, tf = _logml_pair(*_data())
    th = THETA[form]
    close(tf(T(th)), jf(jnp.asarray(th)), rtol=1e-10)
    want = np.asarray(jax.grad(jf)(jnp.asarray(th)))
    close(torch.func.grad(tf)(T(th)), want, rtol=1e-10)
    leaf = T(th).requires_grad_(True)  # plain autograd takes the same rule
    tf(leaf).backward()
    close(leaf.grad, want, rtol=1e-10)


@pytest.mark.parametrize("form", ["iso", "ard"])
def test_logml_hessian_matches_jax_hessian(form):
    jf, tf = _logml_pair(*_data(n=25, seed=1))
    th = THETA[form]
    want = np.asarray(jax.hessian(jf)(jnp.asarray(th)))
    scale = np.abs(want).max()
    close(torch.func.jacrev(torch.func.jacrev(tf))(T(th)), want, rtol=0, atol=1e-8 * scale)
    close(torch.autograd.functional.hessian(tf, T(th)), want, rtol=0, atol=1e-8 * scale)


def test_logml_gradient_wrt_data_and_mean_matches_jax():
    x, y = _data(n=20, seed=2)
    k = np.asarray(jgk.covariance_matrix(jgk.se_kernel(1.3, 0.7), jnp.asarray(x), nugget=0.05))
    mean = np.full(20, 0.3)
    want = jax.grad(jgk.gp_log_marginal_likelihood, argnums=(0, 1, 2))(jnp.asarray(k), jnp.asarray(y),
                                                                       jnp.asarray(mean))
    got = torch.func.grad(tgk.gp_log_marginal_likelihood, argnums=(0, 1, 2))(T(k), T(y), T(mean))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-10, atol=1e-12)


def test_vmap_of_grad_over_thetas():
    jf, tf = _logml_pair(*_data(n=20, seed=3))
    rng = np.random.default_rng(4)
    thetas = THETA["iso"] + 0.2 * rng.normal(size=(6, 3))
    got = torch.func.vmap(torch.func.grad(tf))(T(thetas))
    want = jax.vmap(jax.grad(jf))(jnp.asarray(thetas))
    close(got, want, rtol=1e-10)


def test_failed_factorization_gives_sentinel_and_zero_gradient():
    """All-identical inputs, no nugget: K is all ones, the factor is NaN,
    the logML is the sentinel and every gradient is 0 (not NaN)."""
    x = torch.zeros((6, 2), dtype=torch.float64)
    y = T(np.linspace(-1, 1, 6))

    def f(th):
        k = tgk.covariance_matrix(tgk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), x)
        return tgk.gp_log_marginal_likelihood(k, y)

    th = T([0.0, 0.0])
    assert float(f(th)) == -1e300
    assert torch.equal(torch.func.grad(f)(th), torch.zeros(2, dtype=torch.float64))
    leaf = th.clone().requires_grad_(True)
    f(leaf).backward()
    assert torch.equal(leaf.grad, torch.zeros(2, dtype=torch.float64))
    # the same on the matrix itself, batched beside one that factors
    ones = torch.ones((6, 6), dtype=torch.float64)
    good = ones + torch.eye(6, dtype=torch.float64)
    gk, gy = torch.func.grad(lambda k, yy: tgk.gp_log_marginal_likelihood(k, yy).sum(), argnums=(0, 1))(
        torch.stack([ones, good]), y)
    assert torch.equal(gk[0], torch.zeros_like(ones)) and bool(torch.isfinite(gk[1]).all())
    assert bool((gk[1] != 0).any()) and bool(torch.isfinite(gy).all())
    jgrad = jax.grad(jgk.gp_log_marginal_likelihood)(jnp.ones((6, 6)), jnp.asarray(y.numpy()))
    assert not np.asarray(jgrad).any()


@pytest.mark.parametrize("op", ["se_covariance", "se_covariance_fused", "se_covariance_shared", "cholesky"])
def test_op_rules_against_finite_differences(op):
    rng = np.random.default_rng(5)
    if op == "se_covariance":
        args = (T(rng.normal(size=(2, 5, 3))), T(rng.normal(size=(2, 4, 3))), T(rng.uniform(0.5, 2.0, size=2)))
        fn = tgk.se_covariance
    elif op == "se_covariance_fused":  # n = 7: data, variance, ARD lengthscale and nugget, all per matrix
        args = (T(rng.normal(size=(2, 7, 3))), T(rng.uniform(0.5, 2.0, size=2)),
                T(rng.uniform(0.5, 2.0, size=(2, 3))), T(rng.uniform(0.05, 0.5, size=(2, 7))))

        def fn(x, v, l, g):
            return tgk.se_covariance(x, None, v, l, g)
    elif op == "se_covariance_shared":  # shared data and nugget, a scalar lengthscale per matrix, two inputs
        args = (T(rng.normal(size=(7, 3))), T(rng.normal(size=(4, 3))), T(rng.uniform(0.5, 2.0, size=2)),
                T(rng.uniform(0.5, 2.0, size=(2, 1))), T(rng.uniform(0.05, 0.5, size=())))

        def fn(x1, x2, v, l, g):
            return tgk.se_covariance(x1, x2, v, l).sum(dim=-1) + tgk.se_covariance(x1, None, v, l, g).sum(dim=-1)
    else:
        a = rng.normal(size=(2, 5, 5))
        args = (T(a @ np.swapaxes(a, -1, -2) + 5 * np.eye(5)),)

        def fn(k):  # a symmetric input, as every K the port factors
            return tgk.cholesky(0.5 * (k + k.mT))
    args = tuple(a.requires_grad_(True) for a in args)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_se_covariance_backward_skips_unwanted_cotangents(monkeypatch):
    """Only the cotangents that autograd asks for are computed: the
    hyperparameter paths never pay the data's [n, n] x [n, d] products."""
    rng = np.random.default_rng(9)
    x = T(rng.normal(size=(7, 3)))
    v, l, g = (T(a).requires_grad_(True) for a in (1.3, [0.7, 1.1, 0.9], 0.1))
    products = []
    matmul = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: products.append(1) or matmul(a, b))
    tgk.se_covariance(x, None, v, l, g).sum().backward()
    assert len(products) == 1 and all(t.grad is not None for t in (v, l, g))
    del products[:]
    tgk.se_covariance(x, None, v.detach(), None, g).sum().backward()  # variance fixed, nugget wanted
    assert products == []
    xg = x.clone().requires_grad_(True)
    tgk.se_covariance(xg, None, 1.3, l.detach()).sum().backward()
    assert len(products) == 2 and xg.grad is not None


@pytest.mark.parametrize("nugget", ["scalar", "vector"])
def test_logml_hessian_through_the_fused_call_matches_jax_hessian(nugget):
    """jacrev(jacrev(logML)) with the nugget fused into the covariance call
    (default ``symmetrize``, ARD lengthscales) against ``jax.hessian``."""
    x, y = _data(n=25, seed=10)
    w = np.random.default_rng(11).uniform(0.5, 1.5, size=25) if nugget == "vector" else 1.0
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), T(x), T(y)

    def jf(th):
        return jgk.gp_log_marginal_likelihood(
            jgk.covariance_matrix(jgk.se_kernel(jnp.exp(th[0]), jnp.exp(th[1:-1])), xj,
                                  nugget=jnp.exp(th[-1]) * jnp.asarray(w)), yj)

    def tf(th):
        return tgk.gp_log_marginal_likelihood(
            tgk.covariance_matrix(tgk.se_kernel(torch.exp(th[0]), torch.exp(th[1:-1])), xt,
                                  nugget=torch.exp(th[-1]) * T(w)), yt)

    th = THETA["ard"]
    close(torch.func.grad(tf)(T(th)), jax.grad(jf)(jnp.asarray(th)), rtol=1e-10)
    want = np.asarray(jax.hessian(jf)(jnp.asarray(th)))
    close(torch.func.jacrev(torch.func.jacrev(tf))(T(th)), want, rtol=0, atol=1e-8 * np.abs(want).max())
    thetas = th + 0.1 * np.random.default_rng(12).normal(size=(4, 5))
    close(torch.func.vmap(torch.func.grad(tf))(T(thetas)), jax.vmap(jax.grad(jf))(jnp.asarray(thetas)), rtol=1e-10)


def test_op_rules_under_torch_func_transforms():
    """grad, vmap(grad) and jacrev(jacrev) through both ops equal plain
    autograd through their plain versions."""
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(7, 2)))
    w = T(rng.normal(size=(7, 7)))

    def via_ops(th):
        k = tgk.se_covariance(x * th[1], x * th[1], th[0]) + th[2] * torch.eye(7, dtype=torch.float64)
        return torch.sum(tgk.cholesky(k) * w)

    def via_plain(th):
        k = tgk.se_covariance_plain((x * th[1])[None], (x * th[1])[None], th[0][None])[0]
        return torch.sum(torch.linalg.cholesky(k + th[2] * torch.eye(7, dtype=torch.float64)) * w)

    ths = T(rng.uniform(0.5, 1.5, size=(4, 3)))
    close(torch.func.vmap(torch.func.grad(via_ops))(ths),
          torch.stack([torch.autograd.functional.jacobian(via_plain, t) for t in ths]), rtol=1e-10)
    close(torch.func.jacrev(torch.func.jacrev(via_ops))(ths[0]),
          torch.autograd.functional.hessian(via_plain, ths[0]), rtol=1e-8, atol=1e-10)


_FAMILIES = [
    ("matern12_kernel", (1.3, [0.7, 1.2])),
    ("matern32_kernel", (1.3, 0.8)),
    ("matern52_kernel", (0.9, [0.6, 1.4])),
    ("rational_quadratic_kernel", (1.1, 0.9, 2.5)),
    ("periodic_kernel", (1.2, 0.8, 1.7)),
    ("linear_kernel", ([0.5, 2.0], 0.3)),
    ("constant_kernel", (0.7,)),
    ("white_kernel", (0.2,)),
    ("se_kernel", (1.4, [0.9, 0.5])),
]


@pytest.mark.parametrize("name,args", _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_covariance_families_match_jax(name, args):
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(9, 2)), rng.normal(size=(6, 2))
    jk = getattr(jgk, name)(*(jnp.asarray(v) for v in args))
    tk = getattr(tgk, name)(*(T(v) for v in args))
    close(tk.matrix(T(a), T(b)), jk.matrix(jnp.asarray(a), jnp.asarray(b)), rtol=1e-12, atol=1e-15)
    close(tk.matrix(T(a), T(a)), jk.matrix(jnp.asarray(a), jnp.asarray(a)), rtol=1e-12, atol=1e-15)
    close(tk.diag(T(a)), jk.diag(jnp.asarray(a)), rtol=1e-12)
    assert tk.exactly_symmetric == jk.exactly_symmetric
    # sums and products, and the GP logML through a composite kernel
    jc = jk * jgk.constant_kernel(1.5) + jgk.white_kernel(0.1)
    tc = tk * tgk.constant_kernel(T(1.5)) + tgk.white_kernel(T(0.1))
    y = np.cos(a[:, 0])
    want = jgk.gp_log_marginal_likelihood(jgk.covariance_matrix(jc, jnp.asarray(a), nugget=0.05), jnp.asarray(y))
    got = tgk.gp_log_marginal_likelihood(tgk.covariance_matrix(tc, T(a), nugget=0.05), T(y))
    close(got, want, rtol=1e-10)


def test_predict_grid_from_numpy_integer():
    """``points`` given as a numpy integer is a grid of that many points per
    dimension in both packages (d = 2: 25 points), not one query point."""
    x, y = _data(n=15, d=2, seed=8)
    params = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]
    thetas = np.array([[1.0, 0.8, 0.1], [0.7, 1.3, 0.2]])
    log_w = np.log([0.3, 0.7])
    jp = j_define_gp(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), params,
                     nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3)
    tp = define_gaussian_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), params,
                                 nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3)

    class Samples:
        def __init__(self, pts, lw):
            self.points, self.log_weights = pts, lw

    want = j_predict(Samples(jnp.asarray(thetas), jnp.asarray(log_w)), jp, np.int64(5))
    got = predict_from_gaussian_process(Samples(T(thetas), T(log_w)), tp, np.int64(5))
    assert tuple(got.mean().shape) == (25,) == tuple(np.shape(want.mean()))
    close(got.mean(), want.mean(), rtol=1e-10)
    close(got.variance(), want.variance(), rtol=1e-10)


def test_list_targets_keep_float64():
    """Targets given as a Python list reach the problem in x's dtype
    directly: a list first made a float32 tensor (PyTorch's default dtype)
    lost its digits below 1e-8 before the float64 cast."""
    x = T(np.linspace(-1.0, 1.0, 5)[:, None])
    y = [0.1, 0.2, 0.3, 0.4, 0.7]
    p = define_gaussian_process(x, y, lambda th: tgk.se_kernel(1.0, th[0]), [("l", 0.1, 2.0)],
                                nugget_builder=lambda th: 0.1, prior_distribution=["scale"])
    assert p.metadata["gaussian_process"].y.tolist() == y


@pytest.mark.parametrize("same", [True, False], ids=["symmetric", "cross"])
def test_float32_lengthscale_gradient_on_wide_data(same):
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-30, 30, size=(1, 200, 2)).astype(np.float32)
    x2 = None if same else rng.uniform(-30, 30, size=(1, 150, 2)).astype(np.float32)
    g = rng.normal(size=(1, 200, 200 if same else 150)).astype(np.float32)
    grads = {}
    for dt in (torch.float32, torch.float64):
        ls = torch.tensor([[1.0, 2.0]], dtype=dt, requires_grad=True)
        k = tgk.se_covariance(torch.as_tensor(x1, dtype=dt), None if same else torch.as_tensor(x2, dtype=dt),
                              torch.tensor([1.5], dtype=dt), ls)
        (grads[dt],) = torch.autograd.grad((k * torch.as_tensor(g, dtype=dt)).sum(), ls)
    got, want = grads[torch.float32].double(), grads[torch.float64]
    assert (got - want).norm() <= 1e-6 * want.norm()


def test_float32_cholesky_reverse_rule_is_autograds_order():
    """The op's reverse rule symmetrizes before its solves, as autograd
    through ``torch.linalg.cholesky`` does: the float32 SVGP bound's
    inducing-input gradient through the op equals that path's to 1e-6 of
    its norm (symmetrizing after the solves misses by 7e-5)."""
    from bayesianinference_tpu_torch.ops import gp_laplace, svgp

    rng = np.random.default_rng(1)
    m, b = 64, 1024
    x = rng.uniform(-3, 3, size=(b, 2)).astype(np.float32)
    y = (rng.uniform(size=b) < 0.5).astype(np.float32)
    z = rng.uniform(-3, 3, size=(m, 2)).astype(np.float32)
    mv = (0.5 * rng.normal(size=m)).astype(np.float32)
    raw = (np.eye(m) * np.log(np.expm1(0.5)) + 0.05 * np.tril(rng.normal(size=(m, m)), -1)).astype(np.float32)
    grads = {}
    for name, chol in (("op", svgp.cholesky), ("autograd", lambda k: torch.linalg.cholesky_ex(k)[0])):
        zz = torch.as_tensor(z).requires_grad_(True)
        saved, svgp.cholesky = svgp.cholesky, chol
        try:
            v = svgp.svgp_elbo(tgk.se_kernel(2.0, 1.0), torch.as_tensor(x), torch.as_tensor(y), zz,
                               gp_laplace.bernoulli_logit_likelihood(),
                               svgp.SVGPVariational(torch.as_tensor(mv), torch.as_tensor(raw)), jitter=1e-4,
                               data_scale=256.0)
            (grads[name],) = torch.autograd.grad(v, zz)
        finally:
            svgp.cholesky = saved
    assert (grads["op"] - grads["autograd"]).norm() <= 1e-6 * grads["autograd"].norm()
