"""Gaussian-process covariance kernels and log-marginal likelihood, with
gradients (port of ``bayesianinference_tpu.ops.gp_kernels``).

Two operations run as hand-written CUDA kernels on the card (sources in
``../csrc``), each registered as a ``torch.library`` custom op:

* ``bayesianinference_tpu_torch::se_covariance`` (replaces the Pallas
  ``se_covariance_pallas`` and its ``_se_cov_kernel``): the whole SE
  covariance assembly in one launch and one pass over K,
  ``K[b] = variance[b] * exp(-|(x1[b, i] - x2[b, j]) / l[b]|^2 / 2) + diag(nugget[b])``.
  The lengthscale (scalar or ARD) and the nugget are operands, the data
  goes in unscaled and, where the batch shares it, once; ``x2=None`` is
  the symmetric call (bitwise symmetric K, half the exponentials).
  :func:`se_kernel` fills :class:`Kernel`'s ``matrix_with_nugget`` with it,
  so :func:`covariance_matrix` of an SE kernel is exactly this one kernel.
* ``bayesianinference_tpu_torch::cholesky`` (replaces the Pallas
  ``_chol_pallas_kernel``): the lower factor of every matrix of a batch,
  NaN-propagating on a non-PD input; one launch (a cluster per matrix
  sized to the batch, or the whole card per matrix) up to the route's
  largest n, 256-wide panels above (:func:`_cholesky_route`).

On a CPU tensor each op runs its plain PyTorch version
(:func:`se_covariance_plain`, :func:`cholesky_plain`); on a CUDA tensor it
launches the kernel or raises.  Both ops have a fake (meta) rule and a
``torch.func.vmap`` rule that folds the vmapped dimension into the
kernel's batch dimension, so per-point GP likelihoods batched by
``InferenceProblem`` reach the kernels as one batched launch; an operand
that is not vmapped (the data, under a vmap over hyperparameters) stays
one shared tensor, read through a batch stride of 0.

The wrappers :func:`se_covariance` and :func:`cholesky` carry each op's
reverse rule (``_SECovariance``, ``_Cholesky``), written in differentiable
torch ops, so second derivatives (the Laplace Hessian, taken reverse over
reverse) run through the kernels too; the bare ops have no autograd
formula.  ``torch.func.jacfwd`` does not reach a custom op: take Hessians
with ``torch.func.jacrev(torch.func.jacrev(f))``.

:func:`gp_log_marginal_likelihood` has the JAX package's closed-form
reverse rule d logML/dK = (alpha alpha^T - K^-1)/2, d logML/dy = -alpha
(zero where the factorization failed).  It reads the factor from the
``cholesky`` op as an input, so a second derivative sees how the factor
moves with K.  ``solve_triangular``, ``cholesky_inverse`` and the
log-determinant stay ``torch.linalg`` and plain tensor ops, as the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import csrc
from ..core.numerics import LOG2PI, as_float, exp_neg_precise, log_precise, log_zero
from ..dists.base import as_param

__all__ = [
    "Kernel",
    "se_kernel",
    "matern12_kernel",
    "matern32_kernel",
    "matern52_kernel",
    "rational_quadratic_kernel",
    "periodic_kernel",
    "linear_kernel",
    "constant_kernel",
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
#
# Shapes at the op: x1 [B | 1, n1, d]; x2 None ("x2 is x1") or [B | 1, n2, d];
# variance [B | 1]; lengthscale None or [B | 1, d]; nugget None or
# [B | 1, n1] (only with x2 None).  A leading 1 is shared by every matrix of
# the batch and is never expanded into a copy.


def se_covariance_plain(x1, x2, variance, lengthscale=None, nugget=None) -> torch.Tensor:
    """``variance[b] * exp(-squared_distances(x1[b] / l[b], x2[b] / l[b]) / 2)
    + diag(nugget[b])`` in plain tensor ops, at the op's shapes (above);
    ``x2=None`` means x2 is x1."""
    if x2 is None:
        x2 = x1
    elif nugget is not None:
        raise ValueError("se_covariance: a nugget needs x2=None (the symmetric call)")
    if lengthscale is not None:
        inv = (1.0 / lengthscale)[:, None, :]
        x1, x2 = x1 * inv, x2 * inv
    k = variance[:, None, None] * exp_neg_precise(-0.5 * squared_distances(x1, x2))
    return k if nugget is None else k + torch.diag_embed(nugget)


def _check_cuda(name: str, tensors, dims) -> None:
    for t, nd in zip(tensors, dims):
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA implementation takes CUDA tensors, got {t.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: tensors must share float32 or float64, got {[x.dtype for x in tensors]}")
        if t.dim() != nd:
            raise ValueError(f"{name}: expected {nd}-D tensors, got shape {tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _se_batch(*tensors) -> int:
    """The op's batch size: the leading sizes must all be 1 or one B."""
    sizes = {t.shape[0] for t in tensors if t is not None} - {1}
    if len(sizes) > 1:
        raise ValueError(f"se_covariance: leading sizes {sorted(sizes)} disagree")
    return sizes.pop() if sizes else 1


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [b, n, d] with each matrix's rows contiguous (any batch stride,
    0 for shared data); a copy only where they are not."""
    _, n, d = x.shape
    ok = (d == 1 or x.stride(2) == 1) and (n == 1 or x.stride(1) == d)
    return x if ok else x.contiguous()


def _lead(t: torch.Tensor) -> int:
    """Stride of the leading dim in elements; 0 for one shared by the batch."""
    return 0 if t.shape[0] == 1 else t.stride(0)


def se_covariance_cuda(x1, x2, variance, lengthscale=None, nugget=None, tile: int = 0) -> torch.Tensor:
    """CUDA implementation of the ``se_covariance`` op: one launch of the
    kernel of ``csrc/se_covariance.cu`` on the current stream, reading the
    operands through their strides (nothing is expanded or scaled into a
    copy).  ``tile`` forces the 32- or 64-wide output tile (0: the kernel's
    launcher picks it from the call's shape).  Counts its launches in
    ``se_covariance_cuda.launches``, and by device index in
    ``se_covariance_cuda.launches_by_device``."""
    given = [t for t in (x1, x2, variance, lengthscale, nugget) if t is not None]
    dims = [3] + ([3] if x2 is not None else []) + [1] + ([2] if lengthscale is not None else []) + (
        [2] if nugget is not None else [])
    _check_cuda("se_covariance", given, dims)
    if nugget is not None and x2 is not None:
        raise ValueError("se_covariance: a nugget needs x2=None (the symmetric call)")
    batch = _se_batch(*given)
    n1, d = x1.shape[1:]
    n2 = n1 if x2 is None else x2.shape[1]
    if ((x2 is not None and x2.shape[2] != d) or (lengthscale is not None and lengthscale.shape[1] != d)
            or (nugget is not None and nugget.shape[1] != n1)):
        raise ValueError(f"se_covariance: shapes {[tuple(t.shape) for t in given]} disagree")
    out = torch.empty((batch, n1, n2), dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    x1 = _rows(x1)
    x2 = None if x2 is None else _rows(x2)
    lib = csrc.load_library()
    fn = lib.bi_se_covariance_f64 if x1.dtype == torch.float64 else lib.bi_se_covariance_f32
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        se_covariance_cuda.launches += 1
        se_covariance_cuda.launches_by_device[x1.device.index] += 1
        code = fn(
            ptr(x1), ptr(x2), ptr(variance), ptr(lengthscale), ptr(nugget), out.data_ptr(),
            batch, n1, n2, d,
            _lead(x1), 0 if x2 is None else _lead(x2), _lead(variance),
            0 if lengthscale is None else _lead(lengthscale),
            0 if lengthscale is None else lengthscale.stride(1),
            0 if nugget is None else _lead(nugget), 0 if nugget is None else nugget.stride(1),
            tile, stream,
        )
    csrc.check(code, "se_covariance")
    return out


se_covariance_cuda.launches = 0
se_covariance_cuda.launches_by_device = collections.Counter()


@torch.library.custom_op(f"{_NS}::se_covariance", mutates_args=(), device_types="cpu")
def _se_covariance_op(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    variance: torch.Tensor,
    lengthscale: Optional[torch.Tensor] = None,
    nugget: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return se_covariance_plain(x1, x2, variance, lengthscale, nugget).contiguous()


@_se_covariance_op.register_kernel("cuda")
def _(x1, x2, variance, lengthscale=None, nugget=None):
    return se_covariance_cuda(x1, x2, variance, lengthscale, nugget)


@_se_covariance_op.register_fake
def _(x1, x2, variance, lengthscale=None, nugget=None):
    batch = _se_batch(x1, x2, variance, lengthscale, nugget)
    return x1.new_empty((batch, x1.shape[1], (x1 if x2 is None else x2).shape[1]))


def _fold(t: Optional[torch.Tensor], dim, size: int, batch: int) -> Optional[torch.Tensor]:
    """Merge the vmapped dim (``dim``, of ``size``) into an op's batch dim 0
    (of ``batch``).  An operand that is not vmapped and whose batch dim is 1
    stays as it is, shared by every matrix; any other is a view where its
    strides allow."""
    if t is None:
        return None
    if dim is None:
        if t.shape[0] == 1:
            return t
        t = t.expand(size, *t.shape)
    else:
        t = t.movedim(dim, 0)
        t = t.expand(size, batch, *t.shape[2:])
    return t.reshape(size * batch, *t.shape[2:])


def _se_covariance_vmap(info, in_dims, x1, x2, variance, lengthscale=None, nugget=None):
    v = info.batch_size
    args = (x1, x2, variance, lengthscale, nugget)
    batch = _se_batch(*(t if t is None or dim is None else t.movedim(dim, 0)[0] for t, dim in zip(args, in_dims)))
    out = _se_covariance_op(*(_fold(t, dim, v, batch) for t, dim in zip(args, in_dims)))
    return out.reshape(v, batch, *out.shape[1:]), 0


_se_covariance_op.register_vmap(_se_covariance_vmap)


def _sum_lead(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The cotangent of an operand whose leading dim of 1 was shared by the batch."""
    return g.sum(dim=0, keepdim=True) if like.shape[0] == 1 and g.shape[0] != 1 else g


class _SECovariance(torch.autograd.Function):
    """The ``se_covariance`` op with its reverse rule.  With E the matrix
    without the nugget, P = grad * E, r and c the row and column sums of P
    and l the lengthscale:

      d/dvariance = sum(P) / variance,      d/dnugget = diag(grad),
      d/dl_k = -(2 x1_k^T P x2_k - sum_i r_i x1_ik^2 - sum_j c_j x2_jk^2) / l_k^3,
      d/dx1 = (P x2 - r x1) / l^2,          d/dx2 = (P^T x1 - c x2) / l^2

    (Gram form: the [B, n1, n2, d] difference is never built; with x2 None
    the two data cotangents add).  In float32 the lengthscale's sum is
    taken from direct differences instead, sum_ij P_ij (x1_ik - x2_jk)^2,
    one feature at a time.  The nugget sits on entries of zero
    distance, which drop out of every sum but the variance's, so P is taken
    from the saved K and only that one sum is corrected.  Cotangents that
    ``ctx.needs_input_grad`` does not ask for are skipped: the data's costs
    an [n, n] x [n, d] product that the hyperparameter paths never want.
    The backward is plain differentiable ops on the saved K, so a second
    derivative runs through the op again.

    An ``autograd.Function`` with ``setup_context`` rather than
    ``torch.library.register_autograd``: the Function that the latter
    generates has no ``setup_context``, and ``torch.func`` transforms
    (``grad``, ``vmap(grad)``, ``jacrev``) refuse it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x1, x2, variance, lengthscale, nugget):
        return torch.ops.bayesianinference_tpu_torch.se_covariance(x1, x2, variance, lengthscale, nugget)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, grad):
        x1, x2, variance, scale, nugget, k = ctx.saved_tensors
        inv_l = None if scale is None else 1.0 / scale
        need_x1, need_x2, need_var, need_l, need_nug = ctx.needs_input_grad
        same = x2 is None
        xb = x1 if same else x2
        p = grad * k
        gx1 = gx2 = gvar = gl = gnug = None
        if need_nug:
            gnug = _sum_lead(torch.diagonal(grad, dim1=-2, dim2=-1), nugget)
        if need_var:
            total = p.sum(dim=(-2, -1))
            if nugget is not None:
                total = total - (torch.diagonal(grad, dim1=-2, dim2=-1) * nugget).sum(dim=-1)
            gvar = _sum_lead(total / variance, variance)
        gram_l = need_l and p.dtype == torch.float64
        if need_l and not gram_l:
            # float32: direct differences, one feature at a time (an [n1, n2]
            # temp each); the Gram form's cancellation, sum r x^2 - 2 x^T P x
            # with |x| above the distances, costs the float32 lengthscale
            # gradient a factor of 2-3 in accuracy on data wider than the lengthscale
            squares = torch.stack([(p * (x1[..., :, None, j] - xb[..., None, :, j]).square()).sum(dim=(-2, -1))
                                   for j in range(x1.shape[-1])], dim=-1)
            gl = _sum_lead((inv_l * inv_l * inv_l) * squares, scale)
        if need_x1 or need_x2 or gram_l:
            rows = p.sum(dim=-1, keepdim=True)
            cols = p.sum(dim=-2).unsqueeze(-1)
            px = p @ xb
            if gram_l:
                if same:
                    squares = ((rows + cols) * x1 * x1).sum(dim=-2)
                else:
                    squares = (rows * x1 * x1).sum(dim=-2) + (cols * x2 * x2).sum(dim=-2)
                gl = _sum_lead((inv_l * inv_l * inv_l) * (squares - 2.0 * (x1 * px).sum(dim=-2)), scale)
            l2 = 1.0 if inv_l is None else (inv_l * inv_l)[:, None, :]
            if need_x1:
                gx1 = (px - rows * x1) * l2
                if same:
                    gx1 = gx1 + (p.mT @ x1 - cols * x1) * l2
                gx1 = _sum_lead(gx1, x1)
            if need_x2 and not same:
                gx2 = _sum_lead((p.mT @ x1 - cols * x2) * l2, x2)
        return gx1, gx2, gvar, gl, gnug


def _op_operand(t: torch.Tensor, batch, inner) -> torch.Tensor:
    """``t`` [..., *inner] (its trailing dims broadcastable to ``inner``) at
    the op's shape: [1, *inner] when it has no batch dims of its own (shared
    by every matrix, never copied), else broadcast to ``batch`` and
    flattened to [B, *inner], a view where strides allow."""
    k = len(inner)
    own = t.shape[: max(t.dim() - k, 0)]
    if math.prod(own) == 1:
        return t.expand((*own, *inner)).reshape(1, *inner)
    return t.expand((*batch, *inner)).reshape(-1, *inner)


def se_covariance(x1, x2, variance, lengthscale=None, nugget=None) -> torch.Tensor:
    """``variance * exp(-sum_k ((x1_ik - x2_jk) / lengthscale_k)^2 / 2)
    + [i == j] * nugget_i`` through the custom op: [..., n1, n2].

    x1 [..., n1, d]; x2 [..., n2, d], or ``None`` for "x2 is x1" (the
    symmetric call: K is bitwise symmetric, and only it takes a nugget);
    ``variance`` a scalar or [...]; ``lengthscale`` ``None`` (1), a
    scalar, [d] (ARD) or [..., d]; ``nugget`` ``None``, a scalar, [n1] or
    [..., n1].  Batch dims broadcast; an operand without batch dims of its
    own is passed once, not once per matrix."""
    x1 = as_float(x1)
    x2 = None if x2 is None else as_float(x2).to(x1.dtype)
    if nugget is not None and x2 is not None:
        raise ValueError("se_covariance: a nugget needs x2=None (the symmetric call)")
    n1, d = x1.shape[-2:]
    n2 = n1 if x2 is None else x2.shape[-2]
    small = [None if t is None else as_param(t, x1).to(x1.dtype) for t in (variance, lengthscale, nugget)]
    inner = [(n1, d), (n2, d), (), (d,), (n1,)]
    args = [x1, x2, *small]
    batch = torch.broadcast_shapes(*(t.shape[: max(t.dim() - len(k), 0)] for t, k in zip(args, inner) if t is not None))
    out = _SECovariance.apply(*(None if t is None else _op_operand(t, batch, k) for t, k in zip(args, inner)))
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


# The Cholesky's paths (csrc/cholesky.cu), picked by (B, n, dtype) in
# _cholesky_route: "fused" (one launch, a cluster of C CTAs per matrix),
# "grid" (one cooperative launch, every SM on each matrix in turn) and
# "blocked" (six launches per 256-wide panel, the batch in every launch).
# The thresholds are the measured crossovers of every path and width over
# n = 128-8192 and B = 1-1024 (chip_probe.py --only routes, NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md).  At B = 1 the grid leads from n = 384 to
# 2048 (float64) or 3072 (float32); 8-CTA clusters lead up to n = 640
# while B x 8 CTAs fit the card's 132 SMs; past that, clusters of 2 and
# then 1 CTA lead for n <= 256 and the blocked path everywhere else.
_BLOCKED_NB = 256
_FUSED_MAX_N = 640  # largest n of the 8-CTA clusters
_FULL_CLUSTER_MAX_B = 16  # largest B of the 8-CTA clusters: 128 CTAs
_SMALL_CLUSTER_MAX_N = 256  # largest n of the 2- and 1-CTA clusters above that B
_PAIR_CLUSTER_MAX_B = 64  # largest B of the 2-CTA clusters: 128 CTAs
_GRID_MIN_N = 256  # the grid at B = 1 for n above this ...
_GRID_MAX_N = {torch.float32: 3072, torch.float64: 2048}  # ... up to this


def _cholesky_route(b: int, n: int, dtype: torch.dtype) -> tuple[str, int]:
    """("fused", CTAs per matrix) | ("grid", 0) | ("blocked", panel
    width): the path of the CUDA Cholesky for a batch of b [n, n] matrices
    of ``dtype``."""
    if b == 1 and _GRID_MIN_N < n <= _GRID_MAX_N[dtype]:
        return ("grid", 0)
    if b <= _FULL_CLUSTER_MAX_B:
        return ("fused", 8) if n <= _FUSED_MAX_N else ("blocked", _BLOCKED_NB)
    if n <= _SMALL_CLUSTER_MAX_N:
        return ("fused", 2 if b <= _PAIR_CLUSTER_MAX_B else 1)
    return ("blocked", _BLOCKED_NB)


def _cholesky_launch(k: torch.Tensor, route: str, width: int) -> torch.Tensor:
    """Factor the contiguous CUDA batch ``k`` [B, n, n] by one path of
    ``csrc/cholesky.cu`` (``width``: CTAs per matrix of "fused", the panel
    width of "blocked", unused by "grid") on the current stream; one count
    per call."""
    b, n, _ = k.shape
    out = torch.empty_like(k)
    if out.numel() == 0:
        return out
    lib = csrc.load_library()
    suffix = "f64" if k.dtype == torch.float64 else "f32"
    fn = getattr(lib, f"bi_cholesky_{route}_{suffix}")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        cholesky_cuda.launches += 1
        cholesky_cuda.launches_by_device[k.device.index] += 1
        if route == "grid":
            code = fn(k.data_ptr(), out.data_ptr(), b, n, stream)
        else:
            code = fn(k.data_ptr(), out.data_ptr(), b, n, width, stream)
    csrc.check(code, f"cholesky ({route})")
    return out


def cholesky_cuda(k: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of the ``cholesky`` op: launches the path of
    ``csrc/cholesky.cu`` that :func:`_cholesky_route` picks for the
    batch's size, n and dtype, on the current stream.  Counts its calls in
    ``cholesky_cuda.launches``, and by device index in
    ``cholesky_cuda.launches_by_device``."""
    _check_cuda("cholesky", (k,), (3,))
    n, n2 = k.shape[1:]
    if not k.is_contiguous():
        raise ValueError(f"cholesky: expected a contiguous batch, got strides {k.stride()}")
    if n != n2:
        raise ValueError(f"cholesky: matrices must be square, got {tuple(k.shape)}")
    return _cholesky_launch(k, *_cholesky_route(k.shape[0], n, k.dtype))


cholesky_cuda.launches = 0
cholesky_cuda.launches_by_device = collections.Counter()


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
    out = _cholesky_op(_fold(k, in_dims[0], v, k.movedim(in_dims[0], 0).shape[1]).contiguous())
    return out.reshape(v, -1, *out.shape[1:]), 0


_cholesky_op.register_vmap(_cholesky_vmap)


class _Cholesky(torch.autograd.Function):
    """The ``cholesky`` op with the reverse rule of a Cholesky factor,
    dK = L^-T sym(Phi(L^T dL)) L^-1, Phi = lower triangle with the diagonal
    halved: symmetrized before the two solves, in the order of PyTorch's
    own ``linalg.cholesky`` rule.  Symmetrizing after them instead (the
    same in exact arithmetic) cost the float32 SVGP bound's inducing-input
    gradient 1.4 x in accuracy (``tests/svgp_precision_study.py grad``).
    Differentiable ops on the saved factor (see
    :class:`_SECovariance` for why this is a Function).  A matrix that
    failed to factor (NaN factor) gets a zero gradient, not NaN: the
    ``torch.func`` transforms hand a zero cotangent even to a factor that
    the logML masked out, and NaN * 0 would poison the whole gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k):
        return torch.ops.bayesianinference_tpu_torch.cholesky(k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        # the logML's first derivative sends the factor no gradient; left
        # unmaterialized, that skips this rule's two n x n solves
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:
            return None
        (factor,) = ctx.saved_tensors
        ok = torch.isfinite(torch.diagonal(factor, dim1=-2, dim2=-1)).all(dim=-1)[..., None, None]
        eye = torch.eye(factor.shape[-1], dtype=factor.dtype, device=factor.device)
        factor = torch.where(ok, factor, eye)
        p = (factor.mT @ grad.tril()).tril()
        p = 0.5 * (p + p.tril(-1).mT)
        p = torch.linalg.solve_triangular(factor.mT, p, upper=True)
        p = torch.linalg.solve_triangular(factor, p, upper=False, left=False)
        return torch.where(ok, p, 0.0)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [..., n, n] through the custom op."""
    n = k.shape[-1]
    out = _Cholesky.apply(k.reshape(-1, n, n).contiguous())
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
    0.5 (K + K^T) pass.

    ``matrix_with_nugget(x, nugget_vector) -> [n, n]``, where a family has
    it, gives ``matrix(x, x) + diag(nugget_vector)`` in one pass over K;
    :func:`covariance_matrix` uses it.  Sums and products leave it empty
    and take the general path."""

    matrix: Callable
    diag: Callable
    exactly_symmetric: bool = False
    matrix_with_nugget: Optional[Callable] = None

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
    scalar or [d] (ARD).  Its matrix is one call of the ``se_covariance``
    op on the unscaled inputs; ``matrix(x, x)`` (the same object twice) and
    ``matrix_with_nugget`` make the symmetric call."""

    def matrix(a, b):
        same = a is b
        a = as_float(a)
        return se_covariance(a, None if same else as_float(b), variance, lengthscale)

    def matrix_with_nugget(a, nugget):
        a = as_float(a)
        return se_covariance(a, None, variance, lengthscale, nugget)

    def diag(a):
        a = as_float(a)
        return as_param(variance, a) * torch.ones(a.shape[0], dtype=a.dtype, device=a.device)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True, matrix_with_nugget=matrix_with_nugget)


def _stationary(f_of_sqdist: Callable, variance, lengthscale=1.0) -> Kernel:
    """Stationary kernel v * f(|x - x'|^2) in lengthscale-rescaled inputs
    (``lengthscale`` scalar or [d], ARD), plain torch through
    :func:`squared_distances`."""

    def matrix(a, b):
        a, b = as_float(a), as_float(b)
        inv = 1.0 / as_param(lengthscale, a)
        return as_param(variance, a) * f_of_sqdist(squared_distances(a * inv, b * inv))

    def diag(a):
        a = as_float(a)
        return as_param(variance, a) * torch.ones(a.shape[0], dtype=a.dtype, device=a.device)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True)


def matern12_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-1/2 (Ornstein-Uhlenbeck): v * exp(-r / l)."""
    return _stationary(lambda sq: exp_neg_precise(-torch.sqrt(sq + 1e-36)), variance, lengthscale)


def matern32_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-3/2: v * (1 + sqrt(3) r / l) exp(-sqrt(3) r / l)."""

    def f(sq):
        r = torch.sqrt(3.0 * sq + 1e-36)
        return (1.0 + r) * exp_neg_precise(-r)

    return _stationary(f, variance, lengthscale)


def matern52_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-5/2: v * (1 + u + u^2/3) exp(-u), u = sqrt(5) r / l."""

    def f(sq):
        r = torch.sqrt(5.0 * sq + 1e-36)
        return (1.0 + r + r * r / 3.0) * exp_neg_precise(-r)

    return _stationary(f, variance, lengthscale)


def rational_quadratic_kernel(variance=1.0, lengthscale=1.0, alpha=1.0) -> Kernel:
    """Rational quadratic: v * (1 + r^2 / (2 a l^2))^-a."""

    def f(sq):
        a = as_param(alpha, sq)
        return exp_neg_precise(-a * log_precise(1.0 + sq / (2.0 * a)))

    return _stationary(f, variance, lengthscale)


def periodic_kernel(variance=1.0, lengthscale=1.0, period=1.0) -> Kernel:
    """Periodic (exp-sine-squared) kernel on the L1 distance."""

    def matrix(a, b):
        a, b = as_float(a), as_float(b)
        v, l, p = (as_param(t, a) for t in (variance, lengthscale, period))
        r = torch.abs(a[:, None, :] - b[None, :, :]).sum(dim=-1)
        return v * exp_neg_precise(-2.0 * torch.sin(math.pi * r / p) ** 2 / l**2)

    def diag(a):
        a = as_float(a)
        return as_param(variance, a) * torch.ones(a.shape[0], dtype=a.dtype, device=a.device)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True)


def linear_kernel(variance=1.0, offset=0.0) -> Kernel:
    """Dot-product kernel v * (x - c).(x' - c); ``variance`` scalar or [d]
    (ARD weight variances, folded into the left factor)."""

    def matrix(a, b):
        a, b = as_float(a), as_float(b)
        sqv, c = torch.sqrt(as_param(variance, a)), as_param(offset, a)
        return ((a - c) * sqv) @ ((b - c) * sqv).mT

    def diag(a):
        a = as_float(a)
        return torch.sum(as_param(variance, a) * (a - as_param(offset, a)) ** 2, dim=-1)

    return Kernel(matrix=matrix, diag=diag, exactly_symmetric=True)


def constant_kernel(variance=1.0) -> Kernel:
    """Constant covariance v (a shared random level across all inputs)."""

    def matrix(a, b):
        a = as_float(a)
        return as_param(variance, a) * torch.ones((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)

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
    0.5 (K + K^T) pass.  A kernel with ``matrix_with_nugget`` (the SE
    kernel) assembles K and its nugget in one call, unless a kernel that
    is not exactly symmetric asks to be symmetrized."""
    x = as_float(x)
    if kernel.matrix_with_nugget is not None and (kernel.exactly_symmetric or not symmetrize):
        return kernel.matrix_with_nugget(x, None if nugget is None else _nugget_vector(nugget, x))
    k = kernel.matrix(x, x)
    if symmetrize:
        k = 0.5 * (k + k.mT)
    if nugget is None:
        return k
    return k + torch.diag_embed(_nugget_vector(nugget, x))


def _inv_from_chol(factor: torch.Tensor) -> torch.Tensor:
    """K^-1 from its lower factor, symmetrized.  ``torch.cholesky_inverse``
    stands in for the JAX package's blocked divide-and-conquer inverse
    (``_tri_inv_lower``), which exists to keep the TPU's matrix unit busy:
    on the H100 ``cholesky_inverse`` is the faster of the two (PERF.md)."""
    k_inv = torch.cholesky_inverse(factor)
    return 0.5 * (k_inv + k_inv.mT)


class _LogML(torch.autograd.Function):
    """logML from a factor the caller took with the ``cholesky`` op.

    Inputs (k, y, factor, ok): ``factor`` is the (failure-masked) factor of
    ``k`` and ``ok`` marks the matrices that factored.  The forward reads
    only ``factor`` and ``y``; the backward gives the closed form
    d/dk = (alpha alpha^T - K^-1)/2, d/dy = -alpha (both zero where
    ``ok`` is false) and nothing for ``factor``.  Because ``factor`` is a
    graph node that depends on ``k`` through the op's own autograd rule,
    differentiating this backward again gives the exact second
    derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k, y, factor, ok):
        n = y.shape[-1]
        w = torch.linalg.solve_triangular(factor, y.unsqueeze(-1), upper=False)[..., 0]
        logdet = 2.0 * torch.sum(log_precise(torch.diagonal(factor, dim1=-2, dim2=-1)), dim=-1)
        out = -0.5 * (n * LOG2PI + logdet + torch.sum(w * w, dim=-1))
        lz = log_zero(out.dtype)
        return torch.where(ok, torch.clamp(out, lz, -lz), torch.full_like(out, lz))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, y, factor, ok = inputs
        ctx.save_for_backward(y, factor, ok)

    @staticmethod
    def backward(ctx, grad):
        y, factor, ok = ctx.saved_tensors
        w = torch.linalg.solve_triangular(factor, y.unsqueeze(-1), upper=False)
        alpha = torch.linalg.solve_triangular(factor.mT, w, upper=True)[..., 0]  # K^-1 y
        dk = 0.5 * (alpha.unsqueeze(-1) * alpha.unsqueeze(-2) - _inv_from_chol(factor))
        dk = torch.where(ok[..., None, None], dk, 0.0)
        dy = torch.where(ok[..., None], -alpha, 0.0)
        return grad[..., None, None] * dk, grad[..., None] * dy, None, None


def gp_log_marginal_likelihood(k_matrix: torch.Tensor, y, mean=None) -> torch.Tensor:
    """Clipped GP log marginal likelihood -(n log 2pi + log|K| + y^T K^-1 y)/2
    through one factorization by the ``cholesky`` op.  A failed
    factorization (any non-finite diagonal entry) gives the log-zero
    sentinel and a zero gradient.  Batched over leading dims of
    ``k_matrix`` [..., n, n]; the gradient is the closed form of
    :class:`_LogML`."""
    y = as_float(y)
    if mean is not None:
        y = y - mean
    n = y.shape[-1]
    factor = cholesky(k_matrix)
    ok = torch.isfinite(torch.diagonal(factor, dim1=-2, dim2=-1)).all(dim=-1)
    eye = torch.eye(n, dtype=factor.dtype, device=factor.device)
    safe = torch.where(ok[..., None, None], factor, eye)
    y = y.expand(*safe.shape[:-1])
    return _LogML.apply(k_matrix, y, safe, ok)


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
