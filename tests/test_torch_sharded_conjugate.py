"""The port's data-sharded conjugate models (``parallel/sharded_conjugate.py``)
against the JAX functions on the 8-device CPU mesh of
``tests/conftest.py`` and against the port's dense engines, float64.

The counterparts of ``tests/test_sharded_conjugate.py``, at its sizes: row
counts that are not multiples of 8 exercise the zero padding and its 0/1
weight column.  The port's mesh is eight shards on the CPU.  Tolerances:
the log evidence and the posterior parameters 1e-10 against the JAX
sharded function and against the dense engine (the JAX test's 1e-9 and
1e-8 for the regressions, 1e-10 for the mean models), the categorical
model 1e-12 with equal counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines.conjugate import BLRParameters as JBLRParameters
from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
from bayesianinference_tpu.parallel import (
    sharded_bayesian_linear_regression as j_blr,
    sharded_categorical_conjugate_model as j_categorical,
    sharded_multinormal_conjugate_model as j_multinormal,
    sharded_normal_conjugate_model as j_normal,
)
from bayesianinference_tpu_torch.engines.conjugate import (
    BLRParameters,
    bayesian_linear_regression,
    categorical_conjugate_model,
    multinormal_conjugate_model,
    normal_conjugate_model,
)
from bayesianinference_tpu_torch.parallel import (
    make_mesh,
    sharded_bayesian_linear_regression,
    sharded_categorical_conjugate_model,
    sharded_multinormal_conjugate_model,
    sharded_normal_conjugate_model,
)

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-13)


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(("data",)), make_mesh(("data",), devices=["cpu"] * 8)


def _blr_fields(r):
    p = r.posterior_parameters
    return {"log_evidence": r.log_evidence, "b": p.b, "v": p.v, "lam": p.lam, "lam_inv": p.lam_inv, "nu": p.nu}


def _check_blr(got, jax_want, dense):
    for name, want in _blr_fields(jax_want).items():
        close(_blr_fields(got)[name], want)
        close(_blr_fields(got)[name], _blr_fields(dense)[name])


def test_sharded_blr_univariate_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    n = 203  # not a multiple of 8: the padding mask
    x = rng.uniform(-2.0, 2.0, (n, 1))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * rng.normal(size=n)
    got = sharded_bayesian_linear_regression(T(x), T(y), mesh, degree=3)
    _check_blr(got, j_blr(jnp.asarray(x), jnp.asarray(y), jmesh, degree=3),
               bayesian_linear_regression(T(x), T(y), degree=3))
    xq = np.linspace(-2.0, 2.0, 7)[:, None]
    close(got.predictive_distribution(T(xq)).loc,
          bayesian_linear_regression(T(x), T(y), degree=3).predictive_distribution(T(xq)).loc)


def test_sharded_blr_multivariate_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    n, m = 117, 2
    x = rng.uniform(-1.0, 1.0, (n, 3))
    y = x @ rng.normal(size=(3, m)) + 0.05 * rng.normal(size=(n, m))
    got = sharded_bayesian_linear_regression(T(x), T(y), mesh)
    assert got.output_dim == 2
    _check_blr(got, j_blr(jnp.asarray(x), jnp.asarray(y), jmesh), bayesian_linear_regression(T(x), T(y)))


def test_sharded_blr_custom_prior_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    n = 60
    x = rng.uniform(-1.0, 1.0, (n, 1))
    y = 0.3 + 2.0 * x[:, 0] + 0.1 * rng.normal(size=n)
    eye = np.eye(2)
    jp = JBLRParameters(b=jnp.asarray([0.5, 1.0]), lam=jnp.asarray(eye * 2.0), lam_inv=jnp.asarray(eye / 2.0),
                        v=jnp.asarray(0.5), nu=jnp.asarray(3.0))
    tp = BLRParameters(b=T([0.5, 1.0]), lam=T(eye * 2.0), lam_inv=T(eye / 2.0), v=T(0.5), nu=T(3.0))
    got = sharded_bayesian_linear_regression(T(x), T(y), mesh, prior=tp)
    _check_blr(got, j_blr(jnp.asarray(x), jnp.asarray(y), jmesh, prior=jp),
               bayesian_linear_regression(T(x), T(y), prior=tp))
    with pytest.raises(ValueError, match="1-D for univariate"):
        sharded_bayesian_linear_regression(T(x), T(y), mesh, prior=BLRParameters(
            b=T(np.zeros((2, 1))), lam=tp.lam, lam_inv=tp.lam_inv, v=tp.v, nu=tp.nu))


def test_sharded_normal_model_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    data = rng.normal(1.3, 0.7, size=101)
    got, want, dense = sharded_normal_conjugate_model(T(data), mesh), j_normal(jnp.asarray(data), jmesh), \
        normal_conjugate_model(T(data))
    for f in ("mu0", "lam", "beta", "nu"):
        close(getattr(got.posterior, f), getattr(want.posterior, f))
        close(getattr(got.posterior, f), getattr(dense.posterior, f))
    close(got.log_evidence, want.log_evidence)
    close(got.log_evidence, dense.log_evidence)
    with pytest.raises(ValueError, match="at least one row"):
        sharded_normal_conjugate_model(torch.zeros(0, dtype=torch.float64), mesh)


def test_sharded_multinormal_model_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    cov = np.asarray([[1.0, 0.4, 0.0], [0.4, 1.2, -0.2], [0.0, -0.2, 0.8]])
    data = rng.multivariate_normal(np.arange(3) * 1.0, cov, size=77)
    got, want, dense = sharded_multinormal_conjugate_model(T(data), mesh), j_multinormal(jnp.asarray(data), jmesh), \
        multinormal_conjugate_model(T(data))
    for f in ("mu0", "lam", "psi", "nu"):
        close(getattr(got.posterior, f), getattr(want.posterior, f))
        close(getattr(got.posterior, f), getattr(dense.posterior, f))
    close(got.log_evidence, want.log_evidence)
    close(got.log_evidence, dense.log_evidence)


def test_sharded_categorical_model_matches_jax_and_dense(meshes, rng):
    jmesh, mesh = meshes
    data = rng.integers(0, 4, size=91).astype(float)
    got = sharded_categorical_conjugate_model(T(data), 4, mesh)
    want = j_categorical(jnp.asarray(data), 4, jmesh)
    dense = categorical_conjugate_model(T(data), num_categories=4)
    np.testing.assert_array_equal(got.posterior.alpha.numpy(), np.asarray(want.posterior.alpha))
    np.testing.assert_array_equal(got.posterior.alpha.numpy(), dense.posterior.alpha.numpy())
    close(got.log_evidence, want.log_evidence, rtol=1e-12)
    close(got.log_evidence, dense.log_evidence, rtol=1e-12)
    with pytest.raises(ValueError, match="integers in"):
        sharded_categorical_conjugate_model(T([5.0]), 3, mesh)


def test_numpy_data_go_to_the_meshs_first_device(meshes, rng):
    _, mesh = meshes
    r = sharded_normal_conjugate_model(rng.normal(size=20), mesh)
    assert r.log_evidence.device == torch.device("cpu")
