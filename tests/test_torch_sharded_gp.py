"""The port's mesh and its row-sharded GP (``parallel/sharding.py``,
``parallel/sharded_gp.py``, ``parallel/sharded_chol.py``) against the JAX
functions on the 8-device CPU mesh of ``tests/conftest.py``, float64.

The port's mesh is eight shards on the CPU (``devices=["cpu"] * 8``); each
JAX result comes from a module-scoped fixture at the JAX tests' own sizes
(``tests/test_parallel.py:95-303``).  Tolerances: the covariance blocks and
the gathered logML 1e-12; the blocked factor 1e-10 of its largest entry and
its log-determinant 1e-12; the blocked logML 1e-12 and its theta-gradient
1e-7 (the JAX test's); the predictive moments 1e-10.  The blocked logML
also runs at block widths that are not the shards' height (a panel band
across two shards), where the port's trailing update is narrower than
JAX's full-width one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
from bayesianinference_tpu.parallel import (
    sharded_cholesky as j_sharded_cholesky,
    sharded_covariance_matrix as j_sharded_covariance_matrix,
    sharded_gp_log_marginal_likelihood as j_sharded_logml,
    sharded_gp_logml_blocked as j_logml_blocked,
    sharded_gp_predict as j_predict,
)
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    replicated,
    shard_data,
    sharded_cholesky,
    sharded_covariance_matrix,
    sharded_gp_log_marginal_likelihood,
    sharded_gp_logml_blocked,
    sharded_gp_predict,
)
from bayesianinference_tpu_torch.parallel.sharding import all_gather, axis_index, pmax, psum, per_position

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(("data",)), make_mesh(("data",), devices=["cpu"] * 8)


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(("runs", "data"), shape=(2, 4), devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and dict(mesh.shape) == {"runs": 2, "data": 4}
    assert mesh.axis_names == ("runs", "data") and mesh.size == 8
    assert make_mesh(("a", "b"), devices=["cpu"] * 3).shape["b"] == 1
    with pytest.raises(ValueError):
        make_mesh(("data",), shape=(3,), devices=["cpu"] * 8)  # does not fit, as in JAX
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(("data",))  # no CPU default


def test_shard_data_replicated_and_collectives_are_scoped_by_axis():
    mesh = make_mesh(("runs", "data"), shape=(2, 4), devices=["cpu"] * 8)
    x = torch.arange(10.0)
    s = shard_data(x, mesh, "data")  # ceil(10 / 4) = 3 rows a shard, the last shorter
    assert [tuple(s[0, i].shape) for i in range(4)] == [(3,), (3,), (3,), (1,)]
    assert torch.equal(s.gather(), x) and s.shape == (10,)
    assert torch.equal(replicated(x, mesh)[1, 3], x)
    idx = axis_index(mesh, "data")
    vals = per_position(mesh, lambda p: torch.tensor([10.0 * p[0] + p[1]]))
    sums = psum(vals, mesh, "data")
    assert [float(sums[r, 0]) for r in range(2)] == [6.0, 46.0]  # within each run's slice
    assert float(psum(vals, mesh, "runs")[0, 3]) == 3.0 + 13.0
    assert float(pmax(vals, mesh, "data")[1, 0]) == 13.0
    assert all_gather(vals, mesh, "data")[1, 2].tolist() == [10.0, 11.0, 12.0, 13.0]
    assert idx[1, 2] == 2


def test_sharded_covariance_and_gathered_logml_match_jax(meshes, rng):
    jmesh, mesh = meshes
    x = rng.normal(size=(128, 2))
    y = rng.normal(size=128)
    k_j = j_sharded_covariance_matrix(jgk.se_kernel(1.3, 0.8), jnp.asarray(x), jmesh, "data", nugget=0.05)
    want = float(j_sharded_logml(jgk.se_kernel(1.3, 0.8), jnp.asarray(x), jnp.asarray(y), jmesh, nugget=0.05))
    k_t = sharded_covariance_matrix(tgk.se_kernel(1.3, 0.8), T(x), mesh, "data", nugget=0.05)
    assert [tuple(k_t[i].shape) for i in range(8)] == [(16, 128)] * 8
    np.testing.assert_allclose(k_t.gather().numpy(), np.asarray(k_j), rtol=1e-12, atol=1e-14)
    got = float(sharded_gp_log_marginal_likelihood(tgk.se_kernel(1.3, 0.8), T(x), T(y), mesh, nugget=0.05))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_sharded_cholesky_matches_jax_and_numpy(meshes, rng):
    jmesh, mesh = meshes
    x = rng.uniform(-2, 2, (1024, 3))
    k = np.asarray(jgk.covariance_matrix(jgk.se_kernel(1.3, 0.8), jnp.asarray(x), nugget=0.1))
    l_j, logdet_j = j_sharded_cholesky(jnp.asarray(k), jmesh, block=128)
    l_t, logdet_t = sharded_cholesky(T(k), mesh, block=128)
    l_t = l_t.gather().numpy()
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=1e-10 * np.abs(l_t).max())
    np.testing.assert_allclose(l_t, np.linalg.cholesky(k), atol=1e-10 * np.abs(l_t).max())
    assert np.all(np.triu(l_t, 1) == 0.0)
    np.testing.assert_allclose(float(logdet_t), float(logdet_j), rtol=1e-12)
    # from the row-sharded covariance too, without a gathered K
    k_rows = sharded_covariance_matrix(tgk.se_kernel(1.3, 0.8), T(x), mesh, nugget=0.1)
    l2, logdet2 = sharded_cholesky(k_rows, mesh, block=128)
    np.testing.assert_allclose(l2.gather().numpy(), l_t, atol=1e-12)
    np.testing.assert_allclose(float(logdet2), float(logdet_t), rtol=1e-13)


@pytest.fixture(scope="module")
def blocked_logml(meshes):
    """The JAX blocked logML and its theta-gradient at n = 1024, block 256."""
    jmesh, _ = meshes
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (1024, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(1024)
    kb = lambda th: jgk.se_kernel(jnp.exp(th[0]), jnp.exp(th[1]))  # noqa: E731
    th = jnp.asarray([0.1, 0.2])
    fn = jax.jit(jax.value_and_grad(lambda t: j_logml_blocked(kb(t), jnp.asarray(x), jnp.asarray(y), jmesh,
                                                              nugget=0.1, block=256)))
    value, grad = fn(th)
    dense = float(jgk.gp_log_marginal_likelihood(jgk.covariance_matrix(kb(th), jnp.asarray(x), nugget=0.1),
                                                 jnp.asarray(y)))
    return x, y, float(value), np.asarray(grad), dense


@pytest.mark.parametrize("block", [256, 128, 512])
def test_sharded_logml_blocked_and_its_gradient_match_jax(meshes, blocked_logml, block):
    """Block 256 on 128-row shards is the JAX test's layout (two shards a
    panel); 128 is one shard a panel and 512 four."""
    _, mesh = meshes
    x, y, want, want_grad, dense = blocked_logml
    th = torch.tensor([0.1, 0.2], dtype=torch.float64, requires_grad=True)
    kern = tgk.se_kernel(torch.exp(th[0]), torch.exp(th[1]))
    got = sharded_gp_logml_blocked(kern, T(x), T(y), mesh, nugget=0.1, block=block)
    (grad,) = torch.autograd.grad(got, th)
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)
    np.testing.assert_allclose(got.item(), dense, rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-7)


def test_sharded_logml_blocked_gives_log_zero_for_a_matrix_that_is_not_pd(meshes, rng):
    _, mesh = meshes
    x = np.repeat(rng.normal(size=(64, 2)), 2, axis=0)  # duplicated rows, no nugget
    got = sharded_gp_logml_blocked(tgk.se_kernel(1.0, 1.0), T(x), T(rng.normal(size=128)), mesh, block=16)
    assert float(got) == -1e300


def test_sharded_predict_matches_jax(meshes, rng):
    jmesh, mesh = meshes
    n, m = 512, 17
    x = rng.normal(size=(n, 2))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] + 0.05 * rng.normal(size=n)
    xq = rng.normal(size=(m, 2))
    mean_j, std_j = j_predict(jgk.se_kernel(1.3, 0.9), jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq), jmesh,
                              nugget=0.05, block=128)
    mean_t, std_t = sharded_gp_predict(tgk.se_kernel(1.3, 0.9), T(x), T(y), T(xq), mesh, nugget=0.05, block=128)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-10, atol=1e-12)
    mean_d, std_d = tgk.gp_posterior_moments(tgk.se_kernel(1.3, 0.9), T(x), T(y), T(xq), nugget=0.05)
    np.testing.assert_allclose(mean_t.numpy(), mean_d.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(std_t.numpy(), std_d.numpy(), rtol=1e-9, atol=1e-9)


def test_sharded_predict_with_mean_fn_and_no_query_nugget_matches_jax(meshes, rng):
    jmesh, mesh = meshes
    n, m = 512, 5
    x = rng.normal(size=(n, 1))
    y = 2.0 + x[:, 0] ** 2 + 0.1 * rng.normal(size=n)
    xq = np.linspace(-1.5, 1.5, m)[:, None]
    mean_j, std_j = j_predict(jgk.matern32_kernel(0.8, 1.1), jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq), jmesh,
                              nugget=0.02, mean_fn=lambda z: 2.0 + jnp.zeros(z.shape[0]), block=64,
                              query_nugget=False)
    mean_t, std_t = sharded_gp_predict(tgk.matern32_kernel(0.8, 1.1), T(x), T(y), T(xq), mesh, nugget=0.02,
                                       mean_fn=lambda z: 2.0 + torch.zeros(z.shape[0], dtype=z.dtype), block=64,
                                       query_nugget=False)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-10, atol=1e-12)
    # a callable nugget enters the predictive variance at the query points
    nug = lambda z: 0.01 + 0.01 * z[:, 0] ** 2  # noqa: E731
    _, std_c = sharded_gp_predict(tgk.se_kernel(1.0, 1.0), T(x), T(y), T(xq), mesh, nugget=nug, block=64)
    _, std_cd = tgk.gp_posterior_moments(tgk.se_kernel(1.0, 1.0), T(x), T(y), T(xq), nugget=nug)
    np.testing.assert_allclose(std_c.numpy(), std_cd.numpy(), rtol=1e-9)


def test_divisibility_and_array_nugget_errors(meshes, rng):
    _, mesh = meshes
    x, y = T(rng.normal(size=(100, 2))), T(rng.normal(size=100))
    kern = tgk.se_kernel(1.0, 1.0)
    with pytest.raises(ValueError, match="divisible by both the mesh axis size 8 and block=64"):
        sharded_gp_logml_blocked(kern, x, y, mesh, nugget=0.1, block=64)
    with pytest.raises(ValueError, match="divisible"):
        sharded_cholesky(torch.eye(96, dtype=torch.float64), mesh, block=64)
    with pytest.raises(ValueError, match="divisible"):
        sharded_gp_predict(kern, x, y, x[:3], mesh, nugget=0.1, block=64)
    x2, y2 = T(rng.normal(size=(128, 2))), T(rng.normal(size=128))
    with pytest.raises(ValueError, match="array nugget defines no query-point value"):
        sharded_gp_predict(kern, x2, y2, x2[:3], mesh, nugget=torch.full((128,), 0.1, dtype=torch.float64), block=64)
    mean, _ = sharded_gp_predict(kern, x2, y2, x2[:3], mesh, nugget=torch.full((128,), 0.1, dtype=torch.float64),
                                 block=64, query_nugget=False)
    assert torch.isfinite(mean).all()
