"""Mesh-sharded Gaussian-process covariance and log marginal likelihood
(port of ``bayesianinference_tpu.parallel.sharded_gp``).

For n of 16k and more the covariance K dominates memory (n^2 x 4 bytes: 1
GiB at 16k, 16 GiB at 64k), so its assembly is split by rows over a mesh
axis: each shard builds its ``[n/P, n]`` row block with one call of the
kernel's matrix (for the SE kernel one launch of the ``se_covariance`` op on
the shard's device) and adds its stretch of the diagonal nugget after the
op, which takes a nugget only on the symmetric call.

:func:`sharded_gp_log_marginal_likelihood` gathers K onto the mesh's first
device and factors it there with the ``cholesky`` op;
:mod:`.sharded_chol` factors it without gathering.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.numerics import as_float
from ..ops.gp_kernels import Kernel, _nugget_vector, gp_log_marginal_likelihood
from .sharding import Mesh, ShardedTensor, _bounds, per_position

__all__ = ["sharded_covariance_matrix", "sharded_gp_log_marginal_likelihood"]


def nugget_vector(nugget, x: torch.Tensor) -> torch.Tensor:
    """The [n] diagonal nugget of inputs ``x`` (zeros for None)."""
    if nugget is None:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return _nugget_vector(nugget, x).to(x.dtype)


def row_block(kernel: Kernel, x: torch.Tensor, nug: torch.Tensor, r0: int, r1: int, device) -> torch.Tensor:
    """Rows [r0, r1) of K = k(x, x) + diag(nug) on ``device``: the kernel's
    two-input matrix of the rows against every input, then the nugget on
    the block's stretch of the global diagonal.  The block is a tensor of
    its own (the SE op's reverse rule keeps the op's output), so callers
    may update it in place."""
    x = x.to(device)
    block = kernel.matrix(x[r0:r1], x)
    if block.requires_grad:
        block = block.clone()
    block.diagonal(offset=r0).add_(nug.to(device)[r0:r1])
    return block


def sharded_covariance_matrix(kernel: Kernel, x, mesh: Mesh, axis_name: str = "data", nugget=None) -> ShardedTensor:
    """K with its rows split over ``axis_name``: each position builds its
    row block on its device (for the SE kernel one ``se_covariance``
    launch).  ``gather()`` gives the whole matrix."""
    x = as_float(x)
    nug = nugget_vector(nugget, x)
    ax = mesh.axis(axis_name)
    bounds = _bounds(x.shape[0], mesh.devices.shape[ax])
    blocks = per_position(mesh, lambda p: row_block(kernel, x, nug, *bounds[p[ax]], mesh.devices[p]))
    return ShardedTensor(mesh, blocks, axis_name)


def sharded_gp_log_marginal_likelihood(kernel: Kernel, x, y, mesh: Mesh, axis_name: str = "data", nugget=None,
                                       mean_fn: Callable = None) -> torch.Tensor:
    """GP logML with the covariance assembled row-sharded, gathered onto
    the mesh's first device and factored there by the ``cholesky`` op: the
    single-device :func:`~..ops.gp_kernels.gp_log_marginal_likelihood`'s
    value."""
    x, y = as_float(x), as_float(y)
    if mean_fn is not None:
        y = y - mean_fn(x)
    k = sharded_covariance_matrix(kernel, x, mesh, axis_name, nugget).gather()
    return gp_log_marginal_likelihood(k, y.to(k.device))
