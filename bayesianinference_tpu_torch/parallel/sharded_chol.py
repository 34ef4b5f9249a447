"""Distributed blocked Cholesky, GP log marginal likelihood and prediction
on a mesh (port of ``bayesianinference_tpu.parallel.sharded_chol``).

K is row-sharded end to end: each of the P shards builds and holds only its
``[n/P, n]`` row block (for the SE kernel one ``se_covariance`` launch on
its device).  The right-looking factorization runs one ``block``-wide panel
at a time, as one Python loop over panels with per-shard work between the
collectives:

* the shards' rows of the panel column are gathered onto every device of
  the axis (the only collective, ``Tensor.to`` between cards);
* each device factors the ``[b, b]`` diagonal block with the ``cholesky``
  op (so on the card the hand-written kernel, once per device and panel:
  the shards of one device share it, as they would compute the same),
  inverts the factor (``solve_triangular``) and forms the panel column of
  L as one product;
* the forward substitution ``w = L^-1 rhs`` on a copy of the right-hand
  sides interleaves with the panels, on the first device only, so logML =
  -(n log 2 pi + log det + |w|^2) / 2 and the predictive moments need no
  second pass over L;
* each shard applies the trailing update to its own rows as one
  ``addmm_``.

Departure from the JAX function, with the same results: its trailing update
multiplies over the full width (``a_local - lrows @ lcol.T``, 2 n^3 flops
in all); here each shard updates only its rows below the panel and the
columns from the panel's end to the end of the panel band that holds its
last row (about n^3 / 3 flops), which covers every entry a later panel
reads: each diagonal block stays whole and symmetric, as the ``cholesky``
op's reverse rule assumes.  For the same reason the panel gather sends only
rows at and below the panel.  ``sharded_cholesky`` writes L over the
shards' copies of K, one column block per panel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.numerics import LOG2PI, as_float, log_precise, log_zero
from ..ops.gp_kernels import Kernel, cholesky
from .sharded_gp import nugget_vector, row_block
from .sharding import Mesh, ShardedTensor, cat_to, per_position

__all__ = ["sharded_cholesky", "sharded_gp_logml_blocked", "sharded_gp_predict"]


def _check_sizes(n: int, mesh: Mesh, axis_name: str, block: int) -> int:
    n_dev = mesh.shape[axis_name]
    if n % n_dev or n % block:
        raise ValueError(f"n={n} must be divisible by both the mesh axis size {n_dev} and block={block}")
    return n // n_dev


def _factorize(blocks, devices, rhs=None, *, block: int, keep_factor: bool = False):
    """All panels of the row blocks ``blocks`` (block i holds rows
    [i n_loc, (i + 1) n_loc) on ``devices[i]``; updated in place).
    ``rhs``: None or an [n, r] tensor on the first device (a private copy,
    updated in place).  Returns (log det, w = L^-1 rhs or None), both on the
    first device; with ``keep_factor`` the blocks end as L's rows."""
    n_loc, n = blocks[0].shape
    bounds = [(i * n_loc, (i + 1) * n_loc) for i in range(len(blocks))]
    first = devices[0]
    eye = {dev: torch.eye(block, dtype=blocks[0].dtype, device=dev) for dev in dict.fromkeys(devices)}
    logdet = torch.zeros((), dtype=blocks[0].dtype, device=first)
    w_parts = []
    for c0 in range(0, n, block):
        c1 = c0 + block
        # all_gather of the panel column's rows at and below the panel, then
        # the panel's factor and its column of L: once per device, read-only
        # for the shards there
        parts = [b[max(0, c0 - r0):, c0:c1] for b, (r0, r1) in zip(blocks, bounds) if r1 > c0]
        lcols, inv_first = {}, None
        for dev in eye:
            panel = torch.cat([p.to(dev) for p in parts])  # [n - c0, b]
            l_jj = cholesky(panel[:block].contiguous())
            inv_l = torch.linalg.solve_triangular(l_jj, eye[dev], upper=False)
            lcols[dev] = torch.cat([l_jj, panel[block:] @ inv_l.mT])  # L's rows c0..n of the panel's columns
            if dev == first:
                inv_first = inv_l
                logdet = logdet + 2.0 * torch.sum(log_precise(torch.diagonal(l_jj)))
        if rhs is not None:
            w_blk = inv_first @ rhs[c0:c1].clone()
            rhs[c1:].addmm_(lcols[first][block:], w_blk, alpha=-1.0)
            w_parts.append(w_blk)
        for j, dev in enumerate(devices):
            lcol = lcols[dev]
            r0, r1 = bounds[j]
            lo, band_end = max(c1, r0), min(n, -(-r1 // block) * block)
            if r1 > lo and band_end > c1:
                blocks[j][lo - r0:, c1:band_end].addmm_(lcol[lo - c0:r1 - c0], lcol[block:band_end - c0].mT,
                                                        alpha=-1.0)
            if keep_factor:
                col = blocks[j][:, c0:c1]
                top = min(max(c0 - r0, 0), r1 - r0)
                col[:top] = 0.0
                col[top:] = lcol[r0 + top - c0:r1 - c0]
    return logdet, torch.cat(w_parts) if rhs is not None else None


def _own_rows(k, mesh: Mesh, axis_name: str, n_loc: int):
    """Private copies of K's row blocks on the devices along the axis."""
    devices = mesh.axis_devices(axis_name)
    if isinstance(k, ShardedTensor) and k.axis_name == axis_name:
        origin = (0,) * mesh.devices.ndim
        return [k[p].to(d).clone() for p, d in zip(mesh.along(origin, axis_name), devices)], devices
    k = torch.as_tensor(k)
    return [k[i * n_loc:(i + 1) * n_loc].to(d).clone() for i, d in enumerate(devices)], devices


def sharded_cholesky(k, mesh: Mesh, axis_name: str = "data", block: int = 256):
    """(L, log det K) with K and L row-sharded over ``axis_name``; K (a
    tensor, or the :class:`ShardedTensor` of
    :func:`~.sharded_gp.sharded_covariance_matrix`) is never gathered.
    ``n`` must be divisible by ``block`` and by the axis size.  L is a
    :class:`ShardedTensor` (``gather()`` for the whole factor)."""
    n = k.shape[0]
    n_loc = _check_sizes(n, mesh, axis_name, block)
    blocks, devices = _own_rows(k, mesh, axis_name, n_loc)
    with torch.no_grad():
        logdet, _ = _factorize(blocks, devices, block=block, keep_factor=True)
    ax = mesh.axis(axis_name)
    return ShardedTensor(mesh, per_position(mesh, lambda p: blocks[p[ax]].to(mesh.devices[p])), axis_name), logdet


def _shard_rows(kernel, x, nug, mesh, axis_name, n_loc):
    devices = mesh.axis_devices(axis_name)
    return [row_block(kernel, x, nug, i * n_loc, (i + 1) * n_loc, d) for i, d in enumerate(devices)], devices


def sharded_gp_logml_blocked(
    kernel: Kernel,
    x,
    y,
    mesh: Mesh,
    axis_name: str = "data",
    nugget=None,
    mean_fn: Optional[Callable] = None,
    block: int = 256,
) -> torch.Tensor:
    """GP logML with the covariance assembly and the Cholesky both
    row-sharded: each shard builds its ``[n/P, n]`` block of K and the
    panels stream through the gathers.  The value of
    :func:`~..ops.gp_kernels.gp_log_marginal_likelihood`; a failed
    factorization gives the finite log-zero sentinel.  Differentiable in
    the kernel's parameters (autograd through the shards' copies)."""
    x, y = as_float(x), as_float(y)
    if mean_fn is not None:
        y = y - mean_fn(x)
    n = x.shape[0]
    n_loc = _check_sizes(n, mesh, axis_name, block)
    blocks, devices = _shard_rows(kernel, x, nugget_vector(nugget, x), mesh, axis_name, n_loc)
    rhs = y.to(dtype=blocks[0].dtype, device=devices[0])[:, None].clone()
    logdet, w = _factorize(blocks, devices, rhs, block=block)
    out = -0.5 * (n * LOG2PI + logdet + torch.sum(w * w))
    lz = log_zero(out.dtype)
    out = torch.clamp(out, lz, -lz)
    return torch.where(torch.isfinite(out), out, torch.full_like(out, lz))


def sharded_gp_predict(
    kernel: Kernel,
    x,
    y,
    x_query,
    mesh: Mesh,
    axis_name: str = "data",
    nugget=None,
    mean_fn: Optional[Callable] = None,
    block: int = 256,
    query_nugget: bool = True,
):
    """GP posterior predictive moments with K row-sharded end to end (the
    distributed :func:`~..ops.gp_kernels.gp_posterior_moments`).  The
    factorization's interleaved substitution carries [resid | k(X, X*)] as
    right-hand sides (the cross-covariance rows built per shard and
    gathered once), so with v = L^-1 k* and w = L^-1 resid the mean is
    v^T w and the variance kappa - |v|^2 by columns.

    ``query_nugget`` adds the nugget to the predictive variance: a callable
    nugget at ``x_query``, a scalar broadcast; a per-training-point array
    nugget defines no query-point value and is refused with
    ``query_nugget=True``.  Returns (mean [m], std [m]) on the mesh's first
    device."""
    x, y, xq = as_float(x), as_float(y), as_float(x_query)
    resid = y - mean_fn(x) if mean_fn is not None else y
    n, m = x.shape[0], xq.shape[0]
    n_loc = _check_sizes(n, mesh, axis_name, block)
    q_nug = torch.zeros(m, dtype=resid.dtype, device=resid.device)
    if callable(nugget):
        if query_nugget:
            q_nug = torch.broadcast_to(torch.as_tensor(nugget(xq), dtype=resid.dtype, device=resid.device), (m,))
    elif nugget is not None:
        nug_arr = torch.as_tensor(nugget, dtype=resid.dtype, device=resid.device)
        if nug_arr.dim() > 0 and query_nugget:
            raise ValueError("per-training-point array nugget defines no query-point value; pass a callable "
                             "nugget or query_nugget=False")
        if query_nugget:
            q_nug = torch.broadcast_to(nug_arr, (m,))
    with torch.no_grad():
        blocks, devices = _shard_rows(kernel, x, nugget_vector(nugget, x), mesh, axis_name, n_loc)
        cross = [kernel.matrix(x.to(d)[i * n_loc:(i + 1) * n_loc], xq.to(d)) for i, d in enumerate(devices)]
        rhs = torch.cat([resid.to(dtype=blocks[0].dtype, device=devices[0])[:, None], cat_to(cross, devices[0])],
                        dim=1)
        _, w = _factorize(blocks, devices, rhs, block=block)
    first = devices[0]
    wy, v = w[:, 0], w[:, 1:]
    mean_star = v.mT @ wy
    var_star = kernel.diag(xq.to(first)).to(w.dtype) + q_nug.to(first) - torch.sum(v * v, dim=0)
    if mean_fn is not None:
        mean_star = mean_star + mean_fn(xq).to(first)
    return mean_star, torch.sqrt(torch.clamp(var_star, min=0.0))
