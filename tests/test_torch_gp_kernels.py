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
import dataclasses
import itertools
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


def _nugget_forms(n, seed=11):
    """name -> (nugget for the port, the same for the JAX package)."""
    w = np.random.default_rng(seed).uniform(0.01, 0.2, size=n)
    return {
        "scalar": (0.05, 0.05),
        "vector": (T(w), jnp.asarray(w)),
        "callable": (lambda x: 0.02 + 0.1 * x[:, 0] ** 2, lambda x: 0.02 + 0.1 * x[:, 0] ** 2),
    }


@pytest.mark.parametrize("nugget", ["scalar", "vector"])
def test_fused_covariance_matches_pallas_interpret_f32(nugget):
    """The one-call assembly against the TPU function it ports (scale,
    exponentiate, add the nugget), float32, the Pallas kernel's own bound."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(70, 3)).astype(np.float32)
    nug = 0.05 if nugget == "scalar" else rng.uniform(0.01, 0.2, size=70).astype(np.float32)
    want = jgk.se_covariance_pallas(jnp.asarray(x), 1.5, 0.8, nugget=jnp.asarray(nug), block=64, interpret=True)
    kernel = tgk.se_kernel(1.5, 0.8)
    assert kernel.matrix_with_nugget is not None
    got = tgk.covariance_matrix(kernel, T(x, np.float32), nugget=torch.as_tensor(nug), symmetrize=False)
    assert got.dtype == torch.float32
    close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("nugget", ["scalar", "vector", "callable"])
@pytest.mark.parametrize("lengthscale", [0.8, [0.5, 1.5, 2.0]], ids=["iso", "ard"])
def test_fused_covariance_matches_jax_and_the_unfused_composition(lengthscale, nugget):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(33, 3))
    nug_t, nug_j = _nugget_forms(33)[nugget]
    want = jgk.covariance_matrix(jgk.se_kernel(1.7, jnp.asarray(lengthscale)), jnp.asarray(x), nugget=nug_j)
    kernel = tgk.se_kernel(1.7, T(lengthscale))
    xt = T(x)
    for symmetrize in (True, False):
        got = tgk.covariance_matrix(kernel, xt, nugget=nug_t, symmetrize=symmetrize)
        close(got, want, rtol=1e-12)
        assert torch.equal(got, got.mT)
        unfused = kernel.matrix(xt, xt.clone()) + torch.diag_embed(tgk._nugget_vector(nug_t, xt))
        close(got, unfused, rtol=1e-15, atol=1e-15)
    close(tgk.covariance_matrix(kernel, xt), jgk.covariance_matrix(jgk.se_kernel(1.7, jnp.asarray(lengthscale)),
                                                                   jnp.asarray(x)), rtol=1e-12)


def _record_plain_calls(monkeypatch):
    """Every call that reaches the op's CPU implementation, with its operands."""
    calls = []
    plain = tgk.se_covariance_plain

    def recorder(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(tgk, "se_covariance_plain", recorder)
    return calls


def test_sums_products_and_asymmetric_kernels_take_the_general_path(monkeypatch):
    rng = np.random.default_rng(14)
    x = rng.normal(size=(20, 2))
    se = tgk.se_kernel(1.3, 0.7)
    for composite in (se + tgk.white_kernel(0.1), se * tgk.constant_kernel(2.0)):
        assert composite.matrix_with_nugget is None
    calls = _record_plain_calls(monkeypatch)
    got = tgk.covariance_matrix(se + tgk.white_kernel(0.1), T(x), nugget=0.05)
    assert [c[4] for c in calls] == [None]  # the op ran without a nugget: added by the general path
    want = jgk.covariance_matrix(jgk.se_kernel(1.3, 0.7) + jgk.white_kernel(0.1), jnp.asarray(x), nugget=0.05)
    close(got, want, rtol=1e-12)
    # a kernel that does not promise exact symmetry is symmetrized the general way...
    loose = dataclasses.replace(se, exactly_symmetric=False)
    del calls[:]
    got = tgk.covariance_matrix(loose, T(x), nugget=0.05, symmetrize=True)
    assert [c[4] for c in calls] == [None]
    close(got, jgk.covariance_matrix(jgk.se_kernel(1.3, 0.7), jnp.asarray(x), nugget=0.05), rtol=1e-12)
    # ... and fused when it is not asked to be, like the exactly symmetric one always
    for kernel, symmetrize in ((loose, False), (se, True), (se, False)):
        del calls[:]
        tgk.covariance_matrix(kernel, T(x), nugget=0.05, symmetrize=symmetrize)
        assert len(calls) == 1 and calls[0][1] is None and calls[0][4] is not None


def test_shared_data_is_not_copied_per_matrix(monkeypatch):
    """The main path's call: thetas vmapped, data shared.  The op gets x
    once ([1, n, d], the caller's storage), x2 as None, and the scalar
    lengthscale and nugget as stride-0 views."""
    rng = np.random.default_rng(15)
    x = T(rng.normal(size=(11, 2)))
    y = x[:, 0].clone()
    thetas = T(rng.uniform(0.3, 2.0, size=(5, 3)))

    def logml(th):
        k = tgk.covariance_matrix(tgk.se_kernel(th[0] ** 2, th[1]), x, th[2] ** 2, symmetrize=False)
        return tgk.gp_log_marginal_likelihood(k, y)

    calls = _record_plain_calls(monkeypatch)
    got = torch.func.vmap(logml)(thetas)
    (x1, x2, variance, scale, nugget), = calls
    assert x2 is None and tuple(x1.shape) == (1, 11, 2) and x1.data_ptr() == x.data_ptr()
    assert tuple(variance.shape) == (5,)
    assert tuple(scale.shape) == (5, 2) and scale.stride(1) == 0
    assert tuple(nugget.shape) == (5, 11) and nugget.stride(1) == 0
    del calls[:]
    close(got, torch.stack([logml(t) for t in thetas]), rtol=1e-13)
    assert all(c[0].data_ptr() == x.data_ptr() and c[0].shape[0] == 1 for c in calls)
    # explicit batch dims: shared data stays [1, n, d], batched data is a view
    xs = T(rng.normal(size=(4, 11, 2)))
    del calls[:]
    tgk.se_covariance(x, None, thetas[:4, 0], thetas[:4, 1:2], 0.1)
    tgk.se_covariance(xs, x, thetas[:4, 0], T([0.5, 2.0]))
    assert [tuple(c[0].shape) for c in calls] == [(1, 11, 2), (4, 11, 2)]
    assert calls[0][0].data_ptr() == x.data_ptr() and calls[1][0].data_ptr() == xs.data_ptr()
    assert tuple(calls[1][1].shape) == (1, 11, 2) and tuple(calls[1][3].shape) == (1, 2)
    assert tuple(calls[0][4].shape) == (1, 11) and calls[0][4].stride(1) == 0


_VMAP_ARGS = ("x1", "x2", "variance", "lengthscale", "nugget")


# every subset of the operands vmapped: no x2 in the symmetric call, no nugget in the other
_VMAP_CASES = [(sym, m) for sym in (True, False) for m in itertools.product([0, 1], repeat=5)
               if any(m) and not m[1 if sym else 4]]


@pytest.mark.parametrize("symmetric,mask", _VMAP_CASES,
                         ids=[("x2_is_x1-" if s_ else "two_inputs-") + "".join(map(str, m)) for s_, m in _VMAP_CASES])
def test_se_covariance_vmap_rule_every_in_dims(symmetric, mask):
    """vmap over every subset of (x1, x2, variance, lengthscale,
    nugget), the rest shared, equals the loop over the vmapped dim."""
    rng = np.random.default_rng(16)
    v, n1, n2, d = 3, 6, 6 if symmetric else 4, 2
    full = {"x1": T(rng.normal(size=(v, n1, d))), "x2": None if symmetric else T(rng.normal(size=(v, n2, d))),
            "variance": T(rng.uniform(0.5, 2.0, size=v)), "lengthscale": T(rng.uniform(0.5, 2.0, size=(v, d))),
            "nugget": T(rng.uniform(0.01, 0.2, size=(v, n1))) if symmetric else None}
    args = [full[name] if m or full[name] is None else full[name][0] for name, m in zip(_VMAP_ARGS, mask)]
    in_dims = tuple(0 if m and a is not None else None for a, m in zip(args, mask))
    got = torch.func.vmap(tgk.se_covariance, in_dims=in_dims)(*args)
    want = torch.stack([tgk.se_covariance(*(a[i] if dim == 0 else a for a, dim in zip(args, in_dims)))
                        for i in range(v)])
    assert tuple(got.shape) == (v, n1, n2)
    close(got, want, rtol=1e-15)
    # the same through the plain version at the op's shapes
    op_args = [None if a is None else (a if dim == 0 else a[None]) for a, dim in zip(args, in_dims)]
    close(got, tgk.se_covariance_plain(*op_args), rtol=1e-15)


def test_se_covariance_nested_vmap_and_moved_dims():
    rng = np.random.default_rng(17)
    x = T(rng.normal(size=(7, 2)))
    var, scale, nug = (T(rng.uniform(0.5, 2.0, size=s)) for s in ((2, 3), (3, 2), (7, 3)))
    inner = torch.func.vmap(lambda v_, l_, g_: tgk.se_covariance(x, None, v_, l_, g_), in_dims=(0, None, 1))
    got = torch.func.vmap(inner, in_dims=(0, 0, None))(var, scale.T.reshape(2, 3)[:, :2].expand(2, 2), nug)
    want = torch.stack([torch.stack([tgk.se_covariance(x, None, var[i, j], scale.T.reshape(2, 3)[i, :2], nug[:, j])
                                     for j in range(3)]) for i in range(2)])
    close(got, want, rtol=1e-15)


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
    ("se_covariance", lambda: (torch.randn(1, 5, 3, dtype=torch.float64), None, torch.rand(2, dtype=torch.float64),
                               torch.rand(2, 1, dtype=torch.float64).expand(2, 3),
                               torch.rand(2, 1, dtype=torch.float64).expand(2, 5))),
    ("se_covariance", lambda: (torch.randn(2, 5, 3, dtype=torch.float64), torch.randn(1, 4, 3, dtype=torch.float64),
                               torch.rand(1, dtype=torch.float64), torch.rand(1, 3, dtype=torch.float64), None)),
    ("cholesky", lambda: (torch.eye(4, dtype=torch.float64).expand(3, 4, 4).contiguous(),)),
])
def test_custom_op_registration(op, args):
    """Schema, fake (meta) rule and dispatch checks of torch.library; no
    gradient is registered, so autograd through the op raises."""
    fn = getattr(torch.ops.bayesianinference_tpu_torch, op).default
    torch.library.opcheck(fn, args(), test_utils=("test_schema", "test_faketensor"))
    inputs = [None if a is None else a.clone().requires_grad_(True) for a in args()]
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


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("b,n,dtype,route", [
    # the slice's batch at the earlier thresholds' sizes: 8-CTA clusters up
    # to n = 640, the blocked path above
    (10, 1, F64, ("fused", 8)), (10, 512, F64, ("fused", 8)), (10, 640, F64, ("fused", 8)),
    (10, 641, F64, ("blocked", 256)), (10, 768, F64, ("blocked", 256)), (10, 1000, F64, ("blocked", 256)),
    (10, 1024, F64, ("blocked", 256)), (10, 1025, F64, ("blocked", 256)), (10, 2048, F64, ("blocked", 256)),
    (10, 16384, F64, ("blocked", 256)),
    # B = 1: 8-CTA clusters to n = 256, the grid above to 2048 (float64) or 3072 (float32)
    (1, 256, F64, ("fused", 8)), (1, 257, F64, ("grid", 0)), (1, 2048, F64, ("grid", 0)),
    (1, 2049, F64, ("blocked", 256)), (1, 256, F32, ("fused", 8)), (1, 257, F32, ("grid", 0)),
    (1, 3072, F32, ("grid", 0)), (1, 3073, F32, ("blocked", 256)), (1, 16384, F32, ("blocked", 256)),
    (2, 257, F32, ("fused", 8)), (2, 1024, F32, ("blocked", 256)),
    # 8-CTA clusters while B x 8 <= 128 CTAs
    (16, 640, F64, ("fused", 8)), (17, 640, F64, ("blocked", 256)), (16, 641, F64, ("blocked", 256)),
    # past that: 2-CTA clusters to B = 64 and 1 CTA a matrix above for n <= 256, blocked for larger n
    (17, 256, F64, ("fused", 2)), (64, 256, F32, ("fused", 2)), (65, 256, F64, ("fused", 1)),
    (1024, 128, F64, ("fused", 1)), (17, 257, F64, ("blocked", 256)), (1024, 512, F64, ("blocked", 256)),
])
def test_cholesky_route(b, n, dtype, route):
    """The measured crossovers (chip_probe.py --only routes): the grid
    takes one mid-size matrix, 8-CTA clusters small ones while the batch
    leaves the card room, smaller clusters the smallest matrices of large
    batches, the blocked path the rest."""
    assert tgk._cholesky_route(b, n, dtype) == route


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
