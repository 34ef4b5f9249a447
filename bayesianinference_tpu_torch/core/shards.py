"""The shards of one batch and the collectives between them.

A coupled engine (HMC's shared warmup, the ensemble's half-updates, IBIS's
weights) may run its batch as several shards, each its block of the batch
on its own device, meeting at every step in a collective: a
:class:`ShardAxis` and the list forms below, ``cat_to`` (the tiled gather),
``sum_to`` (``psum``), ``mean_to`` (the scalar ``pmean``), ``logsumexp_to``
(``pmax`` then ``psum``) and ``welford_to`` (the Chan merge of per-shard
moments), each combining the shards' parts in axis order on one device.
One shard is the one-batch engine: every collective is then its part.
:mod:`..parallel.sharding` builds these from a mesh and re-exports them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .numerics import log_zero, logsumexp

__all__ = ["ShardAxis", "canonical_device", "cat_to", "generator_on", "in_batch_order", "logsumexp_to", "mean_to",
           "sum_to", "welford_to"]


def canonical_device(device) -> torch.device:
    """``device`` as a tensor placed there reports it: ``"cuda"`` names the
    current card."""
    d = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def generator_on(generator: torch.Generator, device) -> torch.Generator:
    """``generator`` itself on its own device; elsewhere a generator of
    that device seeded from it."""
    if canonical_device(device) == canonical_device(generator.device):
        return generator
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


def in_batch_order(parts, groups, device):
    """Tensors of the device groups' results (each [group size, ...]) as one
    [n, ...] tensor on ``device`` in the batch's order."""
    order = torch.argsort(torch.cat([idx.to(device) for idx, _ in groups]))
    return torch.cat([p.to(device) for p in parts])[order]


def cat_to(parts: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The tiled gather of one group's blocks (in axis order) on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sum_to(parts: Sequence, device):
    """One group's values summed in axis order on ``device``: the ``psum``
    whose result the caller keeps once.  Parts that are tuples of tensors
    (a shard's statistics) sum field by field."""
    if isinstance(parts[0], tuple):
        return tuple(sum_to(field, device) for field in zip(*parts))
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def mean_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The ``pmean`` of one group's values (each shard's own mean over its
    equal share of the batch): their sum in axis order over the shard
    count, on ``device``."""
    return sum_to(parts, device) / len(parts)


def logsumexp_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The logsumexp of the concatenation of one group's vectors, on
    ``device``, without gathering them: the shift is the ``pmax`` of the
    parts' maxima (0 where it is not finite, so an all-log-zero group
    gives no NaN) and the sum a ``psum`` of the shifted exponentials.  NaN
    entries count as log-zero and an empty sum gives the sentinel, as
    :func:`..core.numerics.logsumexp` does."""
    lz = log_zero(parts[0].dtype)
    parts = [torch.where(torch.isnan(p), torch.full_like(p, lz), p) for p in parts]
    m = parts[0].amax().to(device)
    for p in parts[1:]:
        m = torch.maximum(m, p.amax().to(device))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = sum_to([torch.exp(p - m.to(p.device)).sum() for p in parts], device)
    return torch.where(s == 0, torch.full_like(s, lz), torch.log(torch.where(s == 0, torch.ones_like(s), s)) + m)


def welford_to(parts: Sequence[tuple], device) -> tuple:
    """The Chan merge of one group's moments (mean [d], M2 [d] or [d, d],
    count), each shard's over an equal count, on ``device``, in the JAX
    package's order: the global mean from the count-weighted ``psum`` of
    the means, then the ``psum`` of each M2 plus its count times the outer
    square of its mean's offset."""
    n = parts[0][2]
    total = n * len(parts)
    mean = sum_to([m * n for m, _, _ in parts], device) / total
    corr = [(m.to(device) - mean) for m, _, _ in parts]
    corr = [torch.outer(c, c) if parts[0][1].dim() == 2 else c * c for c in corr]
    return mean, sum_to([m2.to(device) + n * c for (_, m2, _), c in zip(parts, corr)], device), total


class ShardAxis:
    """The shards of one mesh axis that an engine runs as separate batches,
    meeting in collectives at every step (the ``shard_map`` bodies of the
    JAX package's coupled run-level engines).  Shard s holds block s of the
    batch on ``devices[s]`` (a device may repeat); a collective combines the
    shards' parts in axis order on ``home`` and returns one value there,
    which :meth:`send` copies to every shard's device.  A shard that sits
    on ``home`` reads it without a copy, so shards on one card cost no
    transfer.  With one shard every collective is its part unchanged: the
    one-batch engines run this same code."""

    def __init__(self, devices, home):
        self.devices = [canonical_device(d) for d in devices]
        self.home = canonical_device(home)

    @classmethod
    def one(cls, device) -> "ShardAxis":
        return cls([device], device)

    @property
    def size(self) -> int:
        return len(self.devices)

    def split(self, t: torch.Tensor, dim: int = 0) -> list:
        """``t``'s equal blocks along ``dim`` in shard order, each on its
        shard's device."""
        if self.size == 1:
            return [t.to(self.devices[0])]
        return [b.to(d) for b, d in zip(t.split(t.shape[dim] // self.size, dim), self.devices)]

    def send(self, t: torch.Tensor) -> list:
        """``t`` on every shard's device: one copy per distinct device."""
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
        return [copies[d] for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """The tiled ``all_gather``, kept once on ``home``."""
        return parts[0].to(self.home) if self.size == 1 else cat_to(parts, self.home, dim)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return parts[0].to(self.home) if self.size == 1 else sum_to(parts, self.home)

    def mean(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ``pmean`` of the shards' means."""
        return parts[0].to(self.home) if self.size == 1 else mean_to(parts, self.home)

    def logsumexp(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.size == 1:
            return logsumexp(parts[0]).to(self.home)
        return logsumexp_to(parts, self.home)

    def welford(self, parts: Sequence[tuple]) -> tuple:
        """The shards' (mean, M2, count) moments merged."""
        if self.size == 1:
            return tuple(t.to(self.home) if isinstance(t, torch.Tensor) else t for t in parts[0])
        return welford_to(parts, self.home)
