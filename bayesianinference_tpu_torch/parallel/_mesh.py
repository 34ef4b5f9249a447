"""The ``mesh=`` argument of the run-level parallel engines.

Each JAX engine here is a single-device engine with its mesh axis turned
into a ``shard_map``: its shards run runs, chains, walkers or particles of
one batch.  Where the shards share nothing (the runs of nested sampling
and SMC), the port splits the batch by device: the shards that sit on one
device run as one batch there, on a copy of the problem
(:func:`problem_on`).  Where they meet in collectives at every step (HMC's
global adaptation, the ensemble's half-updates, IBIS's weights, a dynamic-NS
stage), the port runs the shards of a mesh that all sit on the problem's
device as that batch, where each collective is the plain reduction over
it; a mesh over several devices raises there (ROADMAP queue 1 item 9).
Both forms first make the JAX function's check that the batch divides over
the mesh axis."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.problem import InferenceProblem, _tree_map
from .sharding import canonical_device, check_mesh


def mesh_devices(engine: str, mesh, axis_name: str, count: Optional[int], what: str) -> list:
    """The devices along ``mesh``'s ``axis_name`` axis, once ``count`` (the
    batch that ``what`` names in the JAX function's error; None: no check)
    is a multiple of its size."""
    mesh = check_mesh(mesh, engine)
    n_shards = mesh.shape[axis_name]
    if count is not None and count % n_shards:
        raise ValueError(f"{what} must be a multiple of the mesh '{axis_name}' axis size {n_shards}")
    return mesh.axis_devices(axis_name)


def mesh_shards(engine: str, mesh, axis_name: str, count: Optional[int], what: str, problem) -> int:
    """The axis size, for an engine whose shards meet in collectives at
    every step: every shard must sit on the problem's device."""
    devices = mesh_devices(engine, mesh, axis_name, count, what)
    if any(d != problem.device for d in devices):
        raise NotImplementedError(
            f"{engine}(mesh=...) over devices other than the problem's ({problem.device}): spreading the engine over "
            "several cards is ROADMAP queue 1, item 9; a mesh whose shards share the problem's device runs as one "
            "batch there")
    return len(devices)


def problem_on(problem: InferenceProblem, device) -> InferenceProblem:
    """``problem`` with its box and data on ``device``.  Its densities then
    run there as long as they compute on their arguments' device: a
    likelihood that closes over another device's tensors cannot move."""
    if problem.device == canonical_device(device):
        return problem
    move = lambda t: t.to(device) if isinstance(t, torch.Tensor) else t  # noqa: E731
    return dataclasses.replace(problem, lower=problem.lower.to(device), upper=problem.upper.to(device),
                               data=None if problem.data is None else _tree_map(move, problem.data))
