"""Inclusive associative scan over the leading axis, shared by the parallel
Kalman filter and the parallel HMM forward pass.

PyTorch has no associative scan.  This is the odd/even recursion of
``jax.lax.associative_scan`` written out: combine adjacent pairs, scan the
half-length sequence recursively, then fill in the even positions.  The
combine always takes the earlier element on the left, and the elements are
paired as JAX pairs them, so the rounding of a non-commutative combine
follows JAX's closely.  Every level is a few batched tensor operations on
all its pairs at once: log2(T) levels down and log2(T) back up.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``out[0::2] = even``, ``out[1::2] = odd`` along dim 0 (``even`` may be
    one longer than ``odd``)."""
    n = even.shape[0] + odd.shape[0]
    out = torch.empty((n,) + even.shape[1:], dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(combine: Callable, elems: Sequence[torch.Tensor]) -> list:
    """All prefix combinations of ``elems`` (tensors sharing dim 0, the
    sequence axis): ``out[t] = e[0] . e[1] . ... . e[t]`` for the
    associative ``combine(left, right)``, which maps two lists of tensors
    (batched over dim 0) to one."""
    elems = list(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]
