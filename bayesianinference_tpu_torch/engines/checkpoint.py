"""Checkpoint and resume of nested-sampling runs, and result files (port of
``bayesianinference_tpu.engines.checkpoint``).

The loop's :class:`~.nested_sampling.NSState` is the checkpoint: its arrays
fix how the loop goes on.  ``save_ns_run``/``load_ns_run`` keep a run in
one ``.npz`` file, ``resume_nested_sampling_loop`` grows the dead-point
buffers and re-enters the loop, and ``nested_sampling(checkpoint_path=,
checkpoint_every=)`` runs in saved segments.

The file is the JAX package's: ``__meta__`` (JSON: ``n_live``,
``num_delete``, ``capacity``) and one array per field of its ``NSState``,
the evaluation counter as its (hi, lo) int32 pair, so a checkpoint written
by either package resumes in the other.  The port keeps no random key in
its state (randomness comes from the caller's ``torch.Generator``); the
``key`` it writes is the generator's seed as two uint32 words, and the one
it reads is ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..core.containers import WeightedSamples
from ..core.device import resolve_device
from ..core.numerics import log_zero
from ..models.problem import InferenceProblem
from .evidence import MeanAndError, NestedSamplingResult
from .laplace import LaplaceFit
from .nested_sampling import (
    NSRunData,
    default_monte_carlo_steps,
    resolve_monte_carlo_method,
    run_loop_from_state,
    warn_if_slice_steps_below_dim,
)

__all__ = [
    "save_ns_run",
    "load_ns_run",
    "resume_nested_sampling_loop",
    "save_result",
    "load_result",
]


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_ns_run(path, run: NSRunData, generator: Optional[torch.Generator] = None) -> None:
    """Write a run checkpoint: one ``.npz`` with every state array and the
    run's static sizes."""
    from ..interop import ns_state_to_numpy

    seed = 0 if generator is None else generator.initial_seed()
    meta = dict(n_live=run.n_live, num_delete=run.num_delete, capacity=run.capacity)
    np.savez_compressed(
        path,
        __meta__=_meta_array(meta),
        key=np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
        **ns_state_to_numpy(run.state),
    )


def load_ns_run(path, *, device=None, dtype: Optional[torch.dtype] = None) -> NSRunData:
    """Load a checkpoint written by ``save_ns_run`` of either package onto
    ``device`` (default: the card) in ``dtype`` (default: the file's)."""
    from ..interop import ns_state_from_numpy

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {name: np.asarray(z[name]) for name in z.files if name not in ("__meta__", "key")}
    if dtype is None:
        dtype = torch.from_numpy(arrays["live_logl"][:0].copy()).dtype
    return NSRunData(state=ns_state_from_numpy(arrays, device=resolve_device(device), dtype=dtype), **meta)


def resume_nested_sampling_loop(
    problem: InferenceProblem,
    run: NSRunData,
    generator: torch.Generator,
    *,
    extra_iterations: int,
    min_iterations: int = 0,
    monte_carlo_steps=None,
    termination_fraction: float = 0.01,
    min_max_acceptance_rate=(0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum: Optional[float] = None,
    progress_callback=None,
    progress_interval: int = 0,
    interrupt_check=None,
    monte_carlo_method: str = "auto",
    stop_at_log_likelihood: Optional[float] = None,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> NSRunData:
    """Continue a run (loaded or not) for up to ``extra_iterations`` more
    iterations.  The dead buffers, which the loop writes in place, are
    copied and padded to the new capacity, so ``run`` is left as it was; an
    interrupted run resumes with the flag cleared.

    ``monte_carlo_method="auto"`` and ``monte_carlo_steps=None`` resolve by
    dimension as in :func:`~.nested_sampling.nested_sampling_loop`.  (The
    JAX package's resume takes ``"auto"`` as adaptive-Metropolis at every
    dimension and 200 steps; up to d = 16 the two agree.)"""
    s = run.state
    k = run.num_delete
    dim = s.live_points.shape[1]
    new_max = (s.iteration - 1) + extra_iterations
    new_capacity = new_max * k
    pad = new_capacity - run.capacity
    if pad < 0:
        raise ValueError("extra_iterations would shrink the buffer")
    dtype, dev = s.dead_logl.dtype, s.dead_logl.device
    lz = log_zero(dtype)

    def grown(buf, fill):
        tail = torch.full((pad,) + buf.shape[1:], fill, dtype=dtype, device=dev)
        return torch.cat([buf, tail])  # a copy even when pad is 0

    state = dataclasses.replace(
        s,
        dead_points=grown(s.dead_points, 0.0), dead_logl=grown(s.dead_logl, lz),
        dead_logp=grown(s.dead_logp, lz), dead_acc=grown(s.dead_acc, 0.0),
        interrupted=False,
    )
    method = resolve_monte_carlo_method(monte_carlo_method, dim, gradient_check=problem.gradient_sanity)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, dim)
    warn_if_slice_steps_below_dim(method, monte_carlo_steps, dim, chmc_num_leapfrog)
    state = run_loop_from_state(
        problem, state, generator,
        n_live=run.n_live, num_delete=k, max_iterations=new_max, min_iterations=min_iterations,
        monte_carlo_steps=monte_carlo_steps, monte_carlo_method=method,
        termination_fraction=termination_fraction, min_max_acceptance_rate=min_max_acceptance_rate,
        covariance_learn_delay=covariance_learn_delay, log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback, progress_interval=progress_interval,
        interrupt_check=interrupt_check, stop_at_log_likelihood=stop_at_log_likelihood,
        chmc_step_size=chmc_step_size, chmc_num_leapfrog=chmc_num_leapfrog,
    )
    return dataclasses.replace(run, state=state, capacity=new_capacity)


# ---------------------------------------------------------------------------
# Result files
# ---------------------------------------------------------------------------

_RESULT_CLASSES = {"NestedSamplingResult": NestedSamplingResult, "LaplaceFit": LaplaceFit}
# result types of the JAX package whose engines the port does not have yet
_WAITING = {
    "SMCResult": "engines/smc.py",
    "HMCResult": "engines/hmc.py",
    "VIResult": "engines/vi.py",
    "PathfinderResult": "engines/pathfinder.py",
}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_result(path, result) -> None:
    """Write a :class:`~.evidence.NestedSamplingResult` or a
    :class:`~.laplace.LaplaceFit` to one ``.npz`` in the JAX package's
    layout.  Tensors, ``MeanAndError`` pairs and ``WeightedSamples`` pools
    round-trip exactly and static fields go to a JSON header; callables
    (``predictive_builder``) and tuples that are not all strings
    (``hyper_path``) are dropped."""
    name = type(result).__name__
    if name not in _RESULT_CLASSES:
        raise NotImplementedError(
            f"save_result: {name} is not a result type of the port"
            + (f" (it waits for the port of {_WAITING[name]})" if name in _WAITING else "")
        )
    arrays = {}
    meta = {"__class__": name}
    for f in dataclasses.fields(result):
        v = getattr(result, f.name)
        if v is None or callable(v):
            continue
        if isinstance(v, WeightedSamples):
            arrays[f.name + ".points"] = _np(v.points)
            arrays[f.name + ".log_weights"] = _np(v.log_weights)
            if v.log_likelihoods is not None:
                arrays[f.name + ".log_likelihoods"] = _np(v.log_likelihoods)
        elif isinstance(v, MeanAndError):
            arrays[f.name + ".mean"] = _np(v.mean)
            arrays[f.name + ".standard_error"] = _np(v.standard_error)
        elif isinstance(v, (int, float, str, bool)):
            meta[f.name] = v
        elif isinstance(v, tuple):
            if all(isinstance(t, str) for t in v):
                meta[f.name] = list(v)
        else:
            arrays[f.name] = _np(v)
    np.savez_compressed(path, __meta__=_meta_array(meta), **arrays)


def load_result(path, *, device=None):
    """Load a result written by ``save_result`` of either package (the class
    comes from the file's header) onto ``device`` (default: the card)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=device)  # noqa: E731
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        name = meta.pop("__class__")
        if name not in _RESULT_CLASSES:
            raise NotImplementedError(
                f"load_result: {name} waits for the port of {_WAITING.get(name, 'its engine')}"
            )
        cls = _RESULT_CLASSES[name]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in meta:
                v = meta[f.name]
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            elif f.name + ".points" in z:
                ll = f.name + ".log_likelihoods"
                kwargs[f.name] = WeightedSamples(
                    points=t(z[f.name + ".points"]),
                    log_weights=t(z[f.name + ".log_weights"]),
                    log_likelihoods=t(z[ll]) if ll in z else None,
                )
            elif f.name + ".mean" in z:
                kwargs[f.name] = MeanAndError(mean=t(z[f.name + ".mean"]),
                                              standard_error=t(z[f.name + ".standard_error"]))
            elif f.name in z:
                kwargs[f.name] = t(z[f.name])
    return cls(**kwargs)
