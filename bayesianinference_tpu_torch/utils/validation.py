"""Function-quality checks (port of ``bayesianinference_tpu.utils.validation``).

The JAX package asks whether a density traces and lowers under ``jax.jit``;
the port batches densities with ``torch.func.vmap`` (``models/problem.py``),
so :func:`check_traceable` asks whether the function batches there.  A
``.item()``, a data-dependent Python branch or an in-place write to an
input makes it fail.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

__all__ = ["check_traceable", "distribution_dimension"]


def check_traceable(fn: Callable, example_args, warn_only: bool = True) -> bool:
    """True if ``fn`` runs under ``torch.func.vmap`` over a batch of two
    copies of the example arguments (each a tensor or a number).  A failure
    warns and returns False with ``warn_only``, and raises ``TypeError``
    otherwise."""
    try:
        batch = [torch.stack([torch.as_tensor(a)] * 2) for a in example_args]
        torch.func.vmap(fn)(*batch)
        return True
    except Exception as e:  # noqa: BLE001 - any failure to batch is the report
        msg = (f"function {getattr(fn, '__name__', fn)!r} does not batch under torch.func.vmap and will "
               f"run one point at a time: {type(e).__name__}: {e}")
        if warn_only:
            warnings.warn(msg, stacklevel=2)
            return False
        raise TypeError(msg) from e


def distribution_dimension(dist) -> int:
    """1 for a scalar distribution, the event size otherwise."""
    n = 1
    for s in getattr(dist, "event_shape", ()):
        n *= s
    return n
