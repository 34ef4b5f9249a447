"""Parity of the port's GP kernels with the JAX package, on the CPU.

On the CPU the two custom ops run their plain PyTorch versions; the
Pallas kernels run in the interpreter as ``tests/test_gp.py`` runs them.
Tolerances:

* float64 covariance and logML/posterior moments against the JAX XLA
  path: rtol 1e-12 for the covariance (same formula, same libm exp) and
  1e-10 for anything through a Cholesky (different factorization order);
* the float32 Pallas SE kernel: atol 2e-5 (its MXU Gram identity
  cancels; the bound of ``tests/test_gp.py``);
* the float32 Pallas Cholesky: atol 5e-4 * max|L| (``tests/test_gp.py``).
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.core.numerics import is_log_zero as j_is_log_zero
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch import csrc
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)
PKG = pathlib.Path(__file__).resolve().parents[1] / "bayesianinference_tpu_torch"


def T(a, dtype=np.float64):
    return torch.tensor(np.array(a, dtype=dtype))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("lengthscale", [0.8, [0.5, 1.5, 2.0]])
def test_se_covariance_matches_jax_covariance_matrix(lengthscale):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3))
    want = jgk.covariance_matrix(jgk.se_kernel(1.7, jnp.asarray(lengthscale)), jnp.asarray(x), nugget=0.05)
    got = tgk.covariance_matrix(tgk.se_kernel(1.7, T(lengthscale)), T(x), nugget=0.05)
    close(got, want, rtol=1e-12)
    inv = 1.0 / np.asarray(lengthscale)
    plain = tgk.se_covariance_plain(T(x * inv)[None], T(x * inv)[None], T([1.7]))[0]
    close(plain + 0.05 * torch.eye(40, dtype=torch.float64), want, rtol=1e-12)
    cross = tgk.se_kernel(1.7, T(lengthscale)).matrix(T(x[:25]), T(x[25:]))
    close(cross, jgk.se_kernel(1.7, jnp.asarray(lengthscale)).matrix(jnp.asarray(x[:25]), jnp.asarray(x[25:])),
          rtol=1e-12)


def test_se_covariance_matches_pallas_interpret_f32():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(70, 3)).astype(np.float32)
    want = jgk.se_covariance_pallas(jnp.asarray(x), 1.5, 0.8, nugget=0.05, block=64, interpret=True)
    got = tgk.covariance_matrix(tgk.se_kernel(1.5, 0.8), T(x, np.float32), nugget=0.05)
    assert got.dtype == torch.float32
    close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("threshold", [None, 10])
def test_squared_distances_both_branches(threshold, monkeypatch):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(9, 3)), rng.normal(size=(7, 3))
    if threshold is not None:  # force the Gram-identity branch on both sides
        monkeypatch.setattr(jgk, "_DIRECT_SQDIST_MAX_ELEMS", threshold)
        monkeypatch.setattr(tgk, "_DIRECT_SQDIST_MAX_ELEMS", threshold)
    close(tgk.squared_distances(T(a), T(b)), jgk.squared_distances(jnp.asarray(a), jnp.asarray(b)),
          rtol=1e-12, atol=1e-14)


def test_cholesky_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    n = 128
    a = rng.standard_normal((n, n)).astype(np.float32)
    k = (a @ a.T + n * np.eye(n)).astype(np.float32)
    want = np.asarray(jgk.cholesky_pallas(jnp.asarray(k), block=128, interpret=True))
    got = tgk.cholesky(T(k, np.float32)).numpy()
    close(got, want, rtol=0, atol=5e-4 * np.abs(want).max())
    assert np.count_nonzero(np.triu(got, 1)) == 0
    # float64: against the dense factor
    k64 = a.astype(np.float64) @ a.T.astype(np.float64) + n * np.eye(n)
    close(tgk.cholesky(T(k64)), np.linalg.cholesky(k64), rtol=1e-10, atol=1e-12)


def test_non_pd_gives_nan_then_logml_sentinel():
    x = np.zeros((5, 1))  # duplicate points, no nugget: singular
    k = tgk.covariance_matrix(tgk.se_kernel(1.0, 1.0), T(x))
    factor = tgk.cholesky(k)
    assert not bool(torch.isfinite(torch.diagonal(factor)).all())
    out = tgk.gp_log_marginal_likelihood(k, torch.ones(5, dtype=torch.float64))
    assert bool(is_log_zero(out)) and bool(torch.isfinite(out))
    jout = jgk.gp_log_marginal_likelihood(jgk.covariance_matrix(jgk.se_kernel(1.0, 1.0), jnp.asarray(x)),
                                          jnp.ones(5))
    assert bool(j_is_log_zero(jout)) and float(out) == float(jout)
    # a batch: only the failed element is NaN
    good = tgk.covariance_matrix(tgk.se_kernel(1.0, 1.0), T(np.arange(5.0)[:, None]), nugget=0.1)
    both = tgk.cholesky(torch.stack([good, k]))
    assert bool(torch.isfinite(both[0]).all()) and bool(torch.isnan(both[1]).all())


def test_logml_and_posterior_moments_match_jax():
    rng = np.random.default_rng(4)
    x, xq = rng.normal(size=(30, 2)), rng.normal(size=(9, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=30)
    mean = np.full(30, 0.3)
    jk = jgk.covariance_matrix(jgk.se_kernel(1.3, 0.7), jnp.asarray(x), nugget=0.02)
    tk = tgk.covariance_matrix(tgk.se_kernel(1.3, 0.7), T(x), nugget=0.02)
    close(tgk.gp_log_marginal_likelihood(tk, T(y)), jgk.gp_log_marginal_likelihood(jk, jnp.asarray(y)), rtol=1e-10)
    close(tgk.gp_log_marginal_likelihood(tk, T(y), mean=T(mean)),
          jgk.gp_log_marginal_likelihood(jk, jnp.asarray(y), mean=jnp.asarray(mean)), rtol=1e-10)
    kern_t = tgk.se_kernel(1.3, 0.7) + tgk.white_kernel(0.01)
    kern_j = jgk.se_kernel(1.3, 0.7) + jgk.white_kernel(0.01)
    mean_fn_t = lambda z: 0.2 * z[:, 0]  # noqa: E731
    mean_fn_j = lambda z: 0.2 * z[:, 0]  # noqa: E731
    got = tgk.gp_posterior_moments(kern_t, T(x), T(y), T(xq), nugget=0.02, mean_fn=mean_fn_t)
    want = jgk.gp_posterior_moments(kern_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq), nugget=0.02,
                                    mean_fn=mean_fn_j)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-10, atol=1e-12)


def test_vmap_over_both_ops_equals_explicit_batch():
    rng = np.random.default_rng(5)
    xs = T(rng.normal(size=(6, 11, 2)))
    var = T(rng.uniform(0.5, 2.0, size=6))
    # both inputs vmapped
    got = torch.func.vmap(lambda a, v: tgk.se_covariance(a, a, v))(xs, var)
    close(got, tgk.se_covariance_plain(xs, xs, var), rtol=1e-15)
    # one input and the variance vmapped, the other shared (in_dim None)
    shared = xs[0, :4]
    got = torch.func.vmap(lambda a, v: tgk.se_covariance(a, shared, v))(xs, var)
    close(got, tgk.se_covariance_plain(xs, shared.expand(6, 4, 2), var), rtol=1e-15)
    # a vmapped dim that is not the leading one
    got = torch.func.vmap(lambda a: tgk.se_covariance(a, a, 1.5), in_dims=1)(xs.transpose(0, 1))
    close(got, tgk.se_covariance_plain(xs, xs, torch.full((6,), 1.5, dtype=torch.float64)), rtol=1e-15)
    ks = tgk.se_covariance_plain(xs, xs, var) + 0.1 * torch.eye(11, dtype=torch.float64)
    close(torch.func.vmap(tgk.cholesky)(ks), tgk.cholesky_plain(ks), rtol=1e-15)
    # nested vmap over a [2, 3] batch of matrices
    nested = torch.func.vmap(torch.func.vmap(tgk.cholesky))(ks.reshape(2, 3, 11, 11))
    close(nested.reshape(6, 11, 11), tgk.cholesky_plain(ks), rtol=1e-15)
    # the GP likelihood batched the way InferenceProblem batches it
    thetas = T(rng.uniform(0.3, 2.0, size=(5, 3)))

    def logml(th):
        k = tgk.covariance_matrix(tgk.se_kernel(th[0] ** 2, th[1]), xs[0], th[2] ** 2)
        return tgk.gp_log_marginal_likelihood(k, xs[0, :, 0])

    close(torch.func.vmap(logml)(thetas), torch.stack([logml(t) for t in thetas]), rtol=1e-13)


@pytest.mark.parametrize("op,args", [
    ("se_covariance", lambda: (torch.randn(2, 5, 3, dtype=torch.float64),) * 2 + (torch.rand(2, dtype=torch.float64),)),
    ("cholesky", lambda: (torch.eye(4, dtype=torch.float64).expand(3, 4, 4).contiguous(),)),
])
def test_custom_op_registration(op, args):
    """Schema, fake (meta) rule and dispatch checks of torch.library; no
    gradient is registered, so autograd through the op raises."""
    fn = getattr(torch.ops.bayesianinference_tpu_torch, op).default
    torch.library.opcheck(fn, args(), test_utils=("test_schema", "test_faketensor"))
    inputs = [a.clone().requires_grad_(True) for a in args()]
    out = fn(*inputs)
    with pytest.raises(RuntimeError, match="autograd"):
        out.sum().backward()


def test_cuda_implementations_refuse_cpu_tensors():
    x = torch.randn(1, 4, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.se_covariance_cuda(x, x, torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tgk.cholesky_cuda(torch.eye(3, dtype=torch.float64)[None])
    assert tgk.se_covariance_cuda.launches == 0 and tgk.cholesky_cuda.launches == 0


@pytest.mark.parametrize("n,route", [
    (1, ("fused", 32)), (512, ("fused", 32)), (1000, ("fused", 32)), (1024, ("fused", 32)),
    (1025, ("blocked", 256)), (2048, ("blocked", 256)), (16384, ("blocked", 256)),
])
def test_cholesky_route(n, route):
    """One launch per call up to n = 1024 (the slice's n = 512 included),
    256-wide panels above."""
    assert tgk._cholesky_route(n) == route


def test_ctypes_table_matches_the_sources():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` is declared in the
    ctypes table with its number of arguments, and nothing else is."""
    import re

    found = {}
    for name in csrc.SOURCES:
        text = (PKG / "csrc" / name).read_text()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[fn] = len(args.split(","))
    assert found == {fn: len(sig) for fn, sig in csrc._SIGNATURES.items()}


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(csrc.os.path, "isfile", lambda p: False)
    csrc.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            csrc.load_library()
    finally:
        csrc.load_library.cache_clear()


def test_port_never_imports_jax():
    """AST scan: no module of the port imports jax (or the JAX package)."""
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "bayesianinference_tpu")]
    assert not offenders, offenders
    assert len(list(PKG.rglob("*.py"))) >= 15
