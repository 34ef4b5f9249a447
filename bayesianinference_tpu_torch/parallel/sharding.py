"""The port's device mesh (port of ``bayesianinference_tpu.parallel.sharding``).

One Python process drives every shard: a :class:`Mesh` names the axes of a
numpy array of ``torch.device``s, each shard's tensors live on its
position's device, and the JAX package's ``shard_map`` bodies become Python
loops over the positions with the collectives below between them.  A device
may repeat, so four shards can share one card (``devices=["cuda:0"] * 4``)
and the tests build an 8-shard mesh on the CPU (``devices=["cpu"] * 8``).
Copies between cards are ``Tensor.to(device)``: peer to peer where the
cards are linked, and a no-op between shards of one device.

The coupled run-level engines (HMC, the ensemble, IBIS) run each shard of
one mesh axis as its own batch and meet at every step in the list forms of
the collectives on a :class:`ShardAxis` (:mod:`..core.shards`, re-exported
here): ``cat_to`` (the tiled gather), ``sum_to``, ``mean_to`` (the scalar
``pmean``), ``logsumexp_to`` (``pmax`` then ``psum``) and ``welford_to``
(the Chan merge of per-shard moments), each combining the shards' parts in
axis order on one device.

The collectives (``axis_index``, ``all_gather``, ``psum``, ``pmax``) act on
per-position values (numpy object arrays of the mesh's shape) and are
scoped as JAX's are: a collective over one axis combines the positions that
differ only along that axis, so a ``psum`` over ``"data"`` stays within its
``(runs, live)`` slice.  Their results on one device may share storage
between the positions there: treat them as read-only.

Not ported: ``P`` and ``NamedSharding``, JAX's placement types.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.shards import (  # noqa: F401  (re-exported: the list collectives and the shard axis)
    ShardAxis,
    canonical_device,
    cat_to,
    generator_on,
    in_batch_order,
    logsumexp_to,
    mean_to,
    sum_to,
    welford_to,
)

__all__ = ["Mesh", "ShardAxis", "ShardedTensor", "make_mesh", "replicated", "shard_data"]


class Mesh:
    """Named axes over an array of devices: ``mesh.shape[name]`` is an axis
    size and ``mesh.axis_names`` the names, as in JAX; ``mesh.devices`` the
    numpy object array of ``torch.device``s."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        out = np.empty(arr.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            out[pos] = canonical_device(arr[pos])
        if out.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {out.shape} needs {out.ndim} axis names, got {tuple(axis_names)}")
        self.devices = out
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names, out.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def positions(self):
        return list(np.ndindex(self.devices.shape))

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def along(self, pos, name: str) -> list:
        """The positions that differ from ``pos`` only along axis ``name``,
        in axis order: the group of a collective over ``name``."""
        ax = self.axis(name)
        return [tuple(pos[:ax]) + (i,) + tuple(pos[ax + 1:]) for i in range(self.devices.shape[ax])]

    def axis_devices(self, name: str) -> list:
        """The devices along axis ``name`` at index 0 of every other axis."""
        return [self.devices[p] for p in self.along((0,) * self.devices.ndim, name)]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


def check_mesh(mesh, entry: str) -> "Mesh":
    """``mesh`` if it is the port's :class:`Mesh`; anything else (a
    ``jax.sharding.Mesh`` among them) raises."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{entry}(mesh=...) takes the port's parallel.Mesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def make_mesh(axis_names: Sequence[str] = ("runs",), shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; there is no CPU
    default).  With ``shape`` None the first axis takes every device and the
    others size 1; a ``shape`` that does not fit the devices raises, as in
    JAX."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices (e.g. ['cpu'] * 8) to build a mesh without one")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


class ShardedTensor:
    """Per-position tensors of a mesh: each position's block on its device.
    ``axis_name`` names the mesh axis that splits the leading dimension (the
    blocks of one group, in axis order, concatenate to the whole), or is
    None for a replicated tensor (each position holds the whole)."""

    def __init__(self, mesh: Mesh, shards: np.ndarray, axis_name: Optional[str] = None):
        self.mesh, self.shards, self.axis_name = mesh, shards, axis_name

    def __getitem__(self, pos) -> torch.Tensor:
        return self.shards[pos]

    @property
    def shape(self) -> tuple:
        first = self.shards.flat[0]
        if self.axis_name is None:
            return tuple(first.shape)
        size = sum(self.shards[p].shape[0] for p in self.mesh.along((0,) * self.mesh.devices.ndim, self.axis_name))
        return (size,) + tuple(first.shape[1:])

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first
        device), from the positions at index 0 of the other axes."""
        device = torch.device(device) if device is not None else self.mesh.first_device
        origin = (0,) * self.mesh.devices.ndim
        if self.axis_name is None:
            return self.shards[origin].to(device)
        return cat_to([self.shards[p] for p in self.mesh.along(origin, self.axis_name)], device)


def per_position(mesh: Mesh, fn: Callable) -> np.ndarray:
    """``fn(pos)`` at every position of the mesh, as an object array."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        out[pos] = fn(pos)
    return out


def _bounds(n: int, parts: int):
    """Row bounds of the ``parts`` blocks of ``n`` rows: ceil(n / parts)
    each, the last ones shorter (or empty), as GSPMD splits an axis."""
    step = -(-n // parts)
    return [(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]


def shard_data(data, mesh: Mesh, axis_name: str) -> ShardedTensor:
    """``data`` with its leading axis split over ``axis_name``: each
    position holds its block on its device (replicated over the other
    axes)."""
    data = torch.as_tensor(data)
    ax = mesh.axis(axis_name)
    bounds = _bounds(data.shape[0], mesh.devices.shape[ax])
    return ShardedTensor(mesh, per_position(mesh, lambda p: data[slice(*bounds[p[ax]])].to(mesh.devices[p])),
                         axis_name)


def pad_rows(arr: torch.Tensor, n_shards: int):
    """``arr`` zero-padded on its leading axis to a multiple of
    ``n_shards``, and the [n_pad] weight column: 1 on real rows, 0 on
    padding (the JAX package's ``_pad_shard``)."""
    n = arr.shape[0]
    n_pad = -(-n // n_shards) * n_shards
    w = torch.zeros((n_pad,), dtype=arr.dtype, device=arr.device)
    w[:n] = 1.0
    if n_pad == n:
        return arr, w
    pad = torch.zeros((n_pad - n,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad]), w


def axis_blocks(mesh: Mesh, axis_name: str, *arrays) -> list:
    """The arrays padded by :func:`pad_rows` and split over ``axis_name``:
    per array (the weight column last) the list of blocks on the devices
    along the axis at index 0 of the other axes."""
    devices = mesh.axis_devices(axis_name)
    out, w = [], None
    for a in arrays:
        a, w = pad_rows(a, len(devices))
        out.append(a)
    step = out[0].shape[0] // len(devices)
    return [[a[i * step:(i + 1) * step].to(d) for i, d in enumerate(devices)] for a in out + [w]]


def device_groups(devices, n: int, home) -> list:
    """The ``n`` items of a batch split evenly over the shards on
    ``devices`` (in order), grouped by device: per device the indices (on
    ``home``) of its shards' items, each group run as one batch.  On one
    device that is the whole batch in order."""
    per = n // len(devices)
    groups = {}
    for s, dev in enumerate(devices):
        groups.setdefault(dev, []).append(torch.arange(s * per, (s + 1) * per, device=home))
    return [(torch.cat(idx), dev) for dev, idx in groups.items()]


def replicated(x, mesh: Mesh) -> ShardedTensor:
    """A copy of ``x`` on every position's device."""
    x = torch.as_tensor(x)
    return ShardedTensor(mesh, per_position(mesh, lambda p: x.to(mesh.devices[p])), None)


# ---------------------------------------------------------------------------
# Collectives over one mesh axis (the shard_map collectives of the JAX
# package).  The engines keep a reduced value once, on one device: they call
# the list forms ``cat_to`` and ``sum_to`` on one group's parts.  The
# object-array forms (``values`` of the mesh's shape) apply those to every
# group and hand each position its copy.
# ---------------------------------------------------------------------------


def _reduce(values: np.ndarray, mesh: Mesh, axis_name: str, combine: Callable) -> np.ndarray:
    out = np.empty(values.shape, dtype=object)
    done = {}
    for pos in mesh.positions():
        group, dev = tuple(mesh.along(pos, axis_name)), mesh.devices[pos]
        if (group, dev) not in done:
            done[(group, dev)] = combine([values[p].to(dev) for p in group])
        out[pos] = done[(group, dev)]
    return out


def axis_index(mesh: Mesh, axis_name: str) -> np.ndarray:
    """Each position's index along ``axis_name``."""
    ax = mesh.axis(axis_name)
    return per_position(mesh, lambda p: p[ax])


def all_gather(values: np.ndarray, mesh: Mesh, axis_name: str, dim: int = 0) -> np.ndarray:
    """Tiled gather: the group's values concatenated along ``dim`` in axis
    order, on each position's device."""
    return _reduce(values, mesh, axis_name, lambda ts: cat_to(ts, ts[0].device, dim))


def psum(values: np.ndarray, mesh: Mesh, axis_name: str) -> np.ndarray:
    """The group's values summed in axis order, on each position's device."""
    return _reduce(values, mesh, axis_name, lambda ts: sum_to(ts, ts[0].device))


def pmax(values: np.ndarray, mesh: Mesh, axis_name: str) -> np.ndarray:
    """The group's elementwise maximum, on each position's device."""

    def largest(ts):
        out = ts[0]
        for t in ts[1:]:
            out = torch.maximum(out, t)
        return out

    return _reduce(values, mesh, axis_name, largest)
