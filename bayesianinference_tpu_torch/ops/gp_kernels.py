"""Gaussian-process covariance kernels and log-marginal likelihood (port of
the nested-sampling GP path of ``bayesianinference_tpu.ops.gp_kernels``).

Two operations run as hand-written CUDA kernels on the card (sources in
``../csrc``), each registered as a ``torch.library`` custom op:

* ``bayesianinference_tpu_torch::se_covariance`` (replaces the Pallas
  ``_se_cov_kernel``): ``K[b] = variance[b] * exp(-|x1[b, i] - x2[b, j]|^2 / 2)``.
* ``bayesianinference_tpu_torch::cholesky`` (replaces the Pallas
  ``_chol_pallas_kernel``): the lower factor of every matrix of a batch,
  NaN-propagating on a non-PD input.

On a CPU tensor each op runs its plain PyTorch version
(:func:`se_covariance_plain`, :func:`cholesky_plain`); on a CUDA tensor it
launches the kernel or raises.  Both ops have a fake (meta) rule and a
``torch.func.vmap`` rule that folds the vmapped dimension into the
kernel's batch dimension, so per-point GP likelihoods batched by
``InferenceProblem`` reach the kernels as one batched launch.  No backward
is registered: asking for a gradient through them raises.

``solve_triangular`` and the log-determinant stay ``torch.linalg`` and
plain tensor ops, as the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import csrc
from ..core.numerics import LOG2PI, as_float, exp_neg_precise, log_precise, log_zero
from ..dists.base import as_param

__all__ = [
    "Kernel",
    "se_kernel",
    "white_kernel",
    "squared_distances",
    "covariance_matrix",
    "gp_log_marginal_likelihood",
    "gp_posterior_moments",
    "se_covariance",
    "se_covariance_plain",
    "se_covariance_cuda",
    "cholesky",
    "cholesky_plain",
    "cholesky_cuda",
]

_NS = "bayesianinference_tpu_torch"

# Largest [n1, n2, d] difference temp (elements) for which
# squared_distances takes the accurate direct-difference form; above it,
# the Gram identity.  The same rule as the JAX package.
_DIRECT_SQDIST_MAX_ELEMS = 1 << 24


def squared_distances(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., n1, n2] of [..., n1, d] and [..., n2, d].

    Direct differences when the per-matrix [n1, n2, d] temp has at most
    2^24 elements (no cancellation); the Gram identity
    |a|^2 + |b|^2 - 2 a.b above that, clamped at 0."""
    n1, d = x1.shape[-2], x1.shape[-1]
    n2 = x2.shape[-2]
    if n1 * n2 * d <= _DIRECT_SQDIST_MAX_ELEMS:
        diff = x1[..., :, None, :] - x2[..., None, :, :]
        return torch.sum(diff * diff, dim=-1)
    sq1 = torch.sum(x1 * x1, dim=-1)
    sq2 = torch.sum(x2 * x2, dim=-1)
    g = x1 @ x2.mT
    return torch.clamp(sq1[..., :, None] + sq2[..., None, :] - 2.0 * g, min=0.0)


# ---------------------------------------------------------------------------
# se_covariance: plain version, CUDA kernel, custom op
# ---------------------------------------------------------------------------


def se_covariance_plain(x1: torch.Tensor, x2: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """``variance[b] * exp(-squared_distances(x1[b], x2[b]) / 2)`` for
    x1 [B, n1, d], x2 [B, n2, d], variance [B]."""
    return variance[:, None, None] * exp_neg_precise(-0.5 * squared_distances(x1, x2))


def _check_cuda(name: str, tensors, dims) -> None:
    for t, nd in zip(tensors, dims):
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA implementation takes CUDA tensors, got {t.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: tensors must share float32 or float64, got {[x.dtype for x in tensors]}")
        if t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {nd}-D tensors, got shape {tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def se_covariance_cuda(x1: torch.Tensor, x2: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of the ``se_covariance`` op: launches the kernel
    of ``csrc/se_covariance.cu`` on the current stream.  Counts its
    launches in ``se_covariance_cuda.launches``."""
    _check_cuda("se_covariance", (x1, x2, variance), (3, 3, 1))
    b, n1, d = x1.shape
    if x2.shape[0] != b or x2.shape[2] != d or variance.shape[0] != b:
        raise ValueError(f"se_covariance: shapes {tuple(x1.shape)}, {tuple(x2.shape)}, {tuple(variance.shape)} disagree")
    n2 = x2.shape[1]
    out = torch.empty((b, n1, n2), dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    lib = csrc.load_library()
    fn = lib.bi_se_covariance_f64 if x1.dtype == torch.float64 else lib.bi_se_covariance_f32
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        se_covariance_cuda.launches += 1
        code = fn(x1.data_ptr(), x2.data_ptr(), variance.data_ptr(), out.data_ptr(), b, n1, n2, d, stream)
    csrc.check(code, "se_covariance")
    return out


se_covariance_cuda.launches = 0


@torch.library.custom_op(f"{_NS}::se_covariance", mutates_args=(), device_types="cpu")
def _se_covariance_op(x1: torch.Tensor, x2: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    return se_covariance_plain(x1, x2, variance)


_se_covariance_op.register_kernel("cuda")(se_covariance_cuda)


@_se_covariance_op.register_fake
def _(x1, x2, variance):
    return x1.new_empty((x1.shape[0], x1.shape[1], x2.shape[1]))


def _fold(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """Move the vmapped dim to the front (or expand an unbatched input) and
    merge it into the op's batch dim 0."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(size, *t.shape)
    return t.reshape(size * t.shape[1], *t.shape[2:]).contiguous()


def _se_covariance_vmap(info, in_dims, x1, x2, variance):
    v = info.batch_size
    out = _se_covariance_op(*(_fold(t, dim, v) for t, dim in zip((x1, x2, variance), in_dims)))
    return out.reshape(v, -1, *out.shape[1:]), 0


_se_covariance_op.register_vmap(_se_covariance_vmap)


def se_covariance(x1, x2, variance) -> torch.Tensor:
    """``variance * exp(-|x1_i - x2_j|^2 / 2)`` for x1 [..., n1, d] and
    x2 [..., n2, d] (already divided by the lengthscale) with a scalar or
    [...] variance: [..., n1, n2] through the custom op."""
    x1, x2 = as_float(x1), as_float(x2)
    variance = as_param(variance, x1).to(x1.dtype)
    batch = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2], variance.shape)
    n1, d = x1.shape[-2:]
    n2 = x2.shape[-2]
    out = torch.ops.bayesianinference_tpu_torch.se_covariance(
        x1.expand(*batch, n1, d).reshape(-1, n1, d).contiguous(),
        x2.expand(*batch, n2, d).reshape(-1, n2, d).contiguous(),
        variance.expand(batch).reshape(-1).contiguous(),
    )
    return out.reshape(*batch, n1, n2)


# ---------------------------------------------------------------------------
# cholesky: plain version, CUDA kernel, custom op
# ---------------------------------------------------------------------------


def cholesky_plain(k: torch.Tensor) -> torch.Tensor:
    """Lower factor of each [n, n] matrix of ``k`` (reading the lower
    triangle).  A failed (non-PD) element's factor is all NaN, the contract
    of XLA's Cholesky: ``torch.linalg.cholesky`` would raise instead."""
    factor, info = torch.linalg.cholesky_ex(k)
    return torch.where((info == 0)[..., None, None], factor, torch.full_like(factor, float("nan")))


def cholesky_cuda(k: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of the ``cholesky`` op: launches the blocked
    factorization of ``csrc/cholesky.cu`` on the current stream.  Counts
    its launches in ``cholesky_cuda.launches``."""
    _check_cuda("cholesky", (k,), (3,))
    b, n, n2 = k.shape
    if n != n2:
        raise ValueError(f"cholesky: matrices must be square, got {tuple(k.shape)}")
    out = torch.empty_like(k)
    if out.numel() == 0:
        return out
    lib = csrc.load_library()
    fn = lib.bi_cholesky_f64 if k.dtype == torch.float64 else lib.bi_cholesky_f32
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        cholesky_cuda.launches += 1
        code = fn(k.data_ptr(), out.data_ptr(), b, n, stream)
    csrc.check(code, "cholesky")
    return out


cholesky_cuda.launches = 0


@torch.library.custom_op(f"{_NS}::cholesky", mutates_args=(), device_types="cpu")
def _cholesky_op(k: torch.Tensor) -> torch.Tensor:
    # cholesky_ex returns column-major factors; the op's output is row-major
    return cholesky_plain(k).contiguous()


_cholesky_op.register_kernel("cuda")(cholesky_cuda)


@_cholesky_op.register_fake
def _(k):
    return torch.empty_like(k)


def _cholesky_vmap(info, in_dims, k):
    v = info.batch_size
    out = _cholesky_op(_fold(k, in_dims[0], v))
    return out.reshape(v, -1, *out.shape[1:]), 0


_cholesky_op.register_vmap(_cholesky_vmap)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [..., n, n] through the custom op."""
    n = k.shape[-1]
    out = torch.ops.bayesianinference_tpu_torch.cholesky(k.reshape(-1, n, n).contiguous())
    return out.reshape(k.shape)


# ---------------------------------------------------------------------------
# Kernels (covariance functions) and the GP likelihood
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A covariance function: ``matrix(x1, x2) -> [n1, n2]`` and
    ``diag(x) -> [n]``.  Compose with ``+`` and ``*``.

    ``exactly_symmetric`` declares that ``matrix(x, x)`` is symmetric to
    the last bit by construction; only then do the logML paths skip the
    0.5 (K + K^T) pass."""

    matrix: Callable
    diag: Callable
    exactly_symmetric: bool = False

    def __add__(self, other: "Kernel") -> "Kernel":
        return Kernel(
            matrix=lambda a, b: self.matrix(a, b) + other.matrix(a, b),
            diag=lambda a: self.diag(a) + other.diag(a),
            exactly_symmetric=self.exactly_symmetric and other.exactly_symmetric,
        )

    def __mul__(self, other: "Kernel") -> "Kernel":
        return Kernel(
            matrix=lambda a, b: self.matrix(a, b) * other.matrix(a, b),
            diag=lambda a: self.diag(a) * other.diag(a),
            exactly_symmetric=self.exactly_symmetric and other.exactly_symmetric,
        )


def se_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Squared-exponential kernel v * exp(-r^2 / (2 l^2)); ``lengthscale``
    scalar or [d] (ARD).  Its matrix is the ``se_covariance`` op on the
    inputs divided by the lengthscale."""

    def matrix(a, b):
        a, b = as_float(a), as_float(b)
        inv = 1.0 / as_param(lengthscale, a)
        return se_covariance(a * inv, b * inv, variance)

    def diag(a):
        a = as_float(a)
        return as_param(variance, a) * torch.ones(a.shape[0], dtype=a.dtype, device=a.device)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True)


def white_kernel(variance=1.0) -> Kernel:
    """Nugget as a kernel: contributes only to the diagonal."""

    def matrix(a, b):
        a = as_float(a)
        return torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)

    def diag(a):
        a = as_float(a)
        return as_param(variance, a) * torch.ones(a.shape[0], dtype=a.dtype, device=a.device)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True)


def _nugget_vector(nugget, x: torch.Tensor) -> torch.Tensor:
    if callable(nugget):
        return nugget(x)
    return torch.broadcast_to(as_param(nugget, x), (x.shape[0],))


def covariance_matrix(kernel: Kernel, x, nugget=None, symmetrize: bool = True) -> torch.Tensor:
    """K = k(x_i, x_j) + diag(nugget(x_i)); ``nugget`` is a scalar, an [n]
    vector or a callable x -> [n].  ``symmetrize=False`` skips the
    0.5 (K + K^T) pass."""
    x = as_float(x)
    k = kernel.matrix(x, x)
    if symmetrize:
        k = 0.5 * (k + k.mT)
    if nugget is None:
        return k
    return k + torch.diag_embed(_nugget_vector(nugget, x))


def gp_log_marginal_likelihood(k_matrix: torch.Tensor, y, mean=None) -> torch.Tensor:
    """Clipped GP log marginal likelihood -(n log 2pi + log|K| + y^T K^-1 y)/2
    through one factorization by the ``cholesky`` op.  A failed
    factorization (any non-finite diagonal entry) gives the log-zero
    sentinel.  Batched over leading dims of ``k_matrix`` [..., n, n]."""
    y = as_float(y)
    if mean is not None:
        y = y - mean
    n = y.shape[-1]
    factor = cholesky(k_matrix)
    ok = torch.isfinite(torch.diagonal(factor, dim1=-2, dim2=-1)).all(dim=-1)
    eye = torch.eye(n, dtype=factor.dtype, device=factor.device)
    safe = torch.where(ok[..., None, None], factor, eye)
    w = torch.linalg.solve_triangular(safe, y.unsqueeze(-1).expand(*safe.shape[:-1], 1), upper=False)[..., 0]
    logdet = 2.0 * torch.sum(log_precise(torch.diagonal(safe, dim1=-2, dim2=-1)), dim=-1)
    out = -0.5 * (n * LOG2PI + logdet + torch.sum(w * w, dim=-1))
    lz = log_zero(out.dtype)
    out = torch.clamp(out, lz, -lz)
    return torch.where(ok, out, torch.full_like(out, lz))


def gp_posterior_moments(
    kernel: Kernel,
    x_train,
    y_train,
    x_query,
    nugget=None,
    mean_fn: Optional[Callable] = None,
    query_nugget: bool = True,
):
    """Posterior predictive moments at query points:
      m* = m(x*) + k*^T K^-1 (y - m(X));   s*^2 = kappa - k*^T K^-1 k*
    where kappa includes the nugget when ``query_nugget``.
    Returns (mean [m], std [m])."""
    x_train, y_train, x_query = as_float(x_train), as_float(y_train), as_float(x_query)
    k_train = covariance_matrix(kernel, x_train, nugget, symmetrize=not kernel.exactly_symmetric)
    k_cross = kernel.matrix(x_train, x_query)  # [n, m]
    kappa = kernel.diag(x_query)
    if query_nugget and nugget is not None:
        kappa = kappa + _nugget_vector(nugget, x_query)
    mean_train = mean_fn(x_train) if mean_fn is not None else 0.0
    mean_query = mean_fn(x_query) if mean_fn is not None else 0.0
    factor = cholesky(k_train)
    resid = (y_train - mean_train).unsqueeze(-1)
    w = torch.linalg.solve_triangular(factor, resid, upper=False)
    alpha = torch.linalg.solve_triangular(factor.mT, w, upper=True)[..., 0]
    mean_star = mean_query + k_cross.mT @ alpha
    v = torch.linalg.solve_triangular(factor, k_cross, upper=False)  # [n, m]
    var_star = kappa - torch.sum(v * v, dim=-2)
    return mean_star, torch.sqrt(torch.clamp(var_star, min=0.0))
