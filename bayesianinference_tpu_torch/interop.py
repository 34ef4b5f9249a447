"""Carry data and state between numpy arrays and the port's tensors.

The JAX package's ``NSState``, ``AMState``, ``SliceState`` and ``CHMCState``
are pytrees of arrays, and its ``NSSegment`` a dataclass of numpy arrays;
taken field by field as ``np.asarray``, they become dicts of numpy arrays,
which the functions here turn into the port's states on a given device and
dtype (and back).  Without ``device=`` the tensors go to the CUDA card,
and the call raises where there is none: ``device="cpu"`` asks for the
host.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.device import resolve_device
from .engines.dynamic_ns import NSSegment
from .engines.nested_sampling import NSState
from .ops.chmc import CHMCState
from .ops.metropolis import AMState
from .ops.slice import SliceState

__all__ = [
    "problem_data_from_numpy",
    "ns_state_from_numpy",
    "ns_state_to_numpy",
    "am_state_from_numpy",
    "am_state_to_numpy",
    "slice_state_from_numpy",
    "slice_state_to_numpy",
    "chmc_state_to_numpy",
    "ns_segment_from_numpy",
]

_EVAL_BASE = 1 << 30  # radix of the JAX package's (hi, lo) int32 eval counter
_NS_TENSORS = (
    "live_points", "live_logl", "live_logp", "dead_points", "dead_logl",
    "dead_logp", "dead_acc", "mean_est", "cov_est", "log_z", "entropy", "log_missing",
)
_AM_FLOATS = ("x", "log_density", "mean", "chol")
_AM_COUNTS = ("step", "accepted", "proposed")


def _float(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype or torch.get_default_dtype())


def problem_data_from_numpy(x, y, *, device=None, dtype: Optional[torch.dtype] = None):
    """(x [n, d], y [n]) as float tensors on ``device`` (default: the card)."""
    device = resolve_device(device)
    return _float(x, device, dtype), _float(y, device, dtype)


def _decode_evals(counter) -> int:
    c = np.asarray(counter)
    if c.shape == (2,):
        return int(c[0]) * _EVAL_BASE + int(c[1])
    return int(c)


def ns_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> NSState:
    """An :class:`NSState` from the fields of the JAX package's ``NSState``
    (``key`` is ignored; the (hi, lo) eval counter becomes one int64), on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    fields = {name: _float(arrays[name], device, dtype) for name in _NS_TENSORS}
    return NSState(
        **fields,
        n_dead=int(np.asarray(arrays["n_dead"])),
        iteration=int(np.asarray(arrays["iteration"])),
        num_likelihood_evals=torch.tensor(
            _decode_evals(arrays["num_likelihood_evals"]), dtype=torch.int64, device=device
        ),
        interrupted=bool(np.asarray(arrays.get("interrupted", False))),
    )


def ns_state_to_numpy(state: NSState) -> dict:
    """The reverse of :func:`ns_state_from_numpy`, with the eval counter as
    the JAX package's (hi, lo) int32 pair."""
    out = {name: getattr(state, name).detach().cpu().numpy() for name in _NS_TENSORS}
    evals = int(state.num_likelihood_evals)
    out["num_likelihood_evals"] = np.asarray(divmod(evals, _EVAL_BASE), np.int32)
    out["n_dead"] = np.asarray(state.n_dead, np.int32)
    out["iteration"] = np.asarray(state.iteration, np.int32)
    out["interrupted"] = np.asarray(state.interrupted)
    return out


def am_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> AMState:
    """An :class:`AMState` of C chains from the fields of the JAX package's
    ``AMState`` vmapped over chains ([C, d], [C], [C, d, d], ...); a single
    chain's fields ([d], scalars, [d, d]) become a batch of one.  On
    ``device`` (default: the card)."""
    device = resolve_device(device)
    x = np.asarray(arrays["x"])
    single = x.ndim == 1
    fix = (lambda a: np.asarray(a)[None]) if single else np.asarray
    floats = {name: _float(fix(arrays[name]), device, dtype) for name in _AM_FLOATS}
    counts = {
        name: torch.as_tensor(np.array(fix(arrays[name])), device=device).to(torch.int64) for name in _AM_COUNTS
    }
    return AMState(**floats, **counts)


def am_state_to_numpy(state: AMState) -> dict:
    """The fields of an :class:`AMState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in AMState._fields}


def slice_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> SliceState:
    """A :class:`SliceState` of C chains from the fields of the JAX package's
    ``SliceState`` vmapped over chains; a single chain's fields become a
    batch of one.  On ``device`` (default: the card)."""
    device = resolve_device(device)
    fix = (lambda a: np.asarray(a)[None]) if np.asarray(arrays["x"]).ndim == 1 else np.asarray
    count = lambda a: torch.as_tensor(np.array(fix(a)), device=device).to(torch.int64)  # noqa: E731
    return SliceState(
        x=_float(fix(arrays["x"]), device, dtype),
        log_density=_float(fix(arrays["log_density"]), device, dtype),
        evals=count(arrays["evals"]),
        moved=count(arrays["moved"]),
    )


def slice_state_to_numpy(state: SliceState) -> dict:
    """The fields of a :class:`SliceState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in SliceState._fields}


def chmc_state_to_numpy(state: CHMCState) -> dict:
    """The fields of a :class:`CHMCState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in CHMCState._fields}


_SEGMENT_ARRAYS = ("points", "log_likelihoods", "log_priors")
_SEGMENT_INTS = ("n_live", "num_delete", "n_dead", "num_likelihood_evals")


def ns_segment_from_numpy(fields: dict) -> NSSegment:
    """An :class:`NSSegment` from the fields of the JAX package's
    ``NSSegment`` (a segment lives on the host in both packages)."""
    return NSSegment(
        **{name: np.asarray(fields[name]) for name in _SEGMENT_ARRAYS},
        **{name: int(fields[name]) for name in _SEGMENT_INTS if name in fields},
        constraint_logl=float(fields["constraint_logl"]),
    )
