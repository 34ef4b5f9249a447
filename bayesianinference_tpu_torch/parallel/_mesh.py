"""The ``mesh=`` argument of the run-level parallel engines.

Each JAX engine here is a single-device engine with its mesh axis turned
into a ``shard_map``: its shards run runs, chains, walkers or particles of
one batch.  Where the shards share nothing (the runs of nested sampling,
SMC and a dynamic-NS stage), the port splits the batch by device: the
shards that sit on one device run as one batch there, on a copy of the
problem (:func:`problem_on`).  Where they meet in collectives at every step
(HMC's global adaptation, the ensemble's half-updates, IBIS's weights),
each shard runs its block of the batch as its own batch on its device,
against that device's copy of the problem, and the collectives combine the
shards in axis order on the problem's device (:func:`shard_axis`,
:class:`.sharding.ShardAxis`).  Both forms first make the JAX function's
check that the batch divides over the mesh axis."""

from __future__ import annotations

from typing import Optional

from ..core.shards import ShardAxis
from ..models.placement import check_movable, problem_on  # noqa: F401  (re-exported for the parallel engines)
from ..models.problem import InferenceProblem
from .sharding import check_mesh


def mesh_devices(engine: str, mesh, axis_name: str, count: Optional[int], what: str) -> list:
    """The devices along ``mesh``'s ``axis_name`` axis, once ``count`` (the
    batch that ``what`` names in the JAX function's error; None: no check)
    is a multiple of its size."""
    mesh = check_mesh(mesh, engine)
    n_shards = mesh.shape[axis_name]
    if count is not None and count % n_shards:
        raise ValueError(f"{what} must be a multiple of the mesh '{axis_name}' axis size {n_shards}")
    return mesh.axis_devices(axis_name)


def shard_axis(engine: str, mesh, axis_name: str, count: int, what: str, problem: InferenceProblem):
    """The shards of ``mesh``'s ``axis_name`` axis for an engine whose
    shards meet in collectives at every step: the :class:`ShardAxis` (home:
    the problem's device) and each shard's copy of the problem, one copy
    per distinct device.  ``mesh`` None is one shard, the problem itself:
    the one-batch run."""
    if mesh is None:
        return ShardAxis.one(problem.device), [problem]
    devices = mesh_devices(engine, mesh, axis_name, count, what)
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = problem_on(problem, d)
    return ShardAxis(devices, problem.device), [copies[d] for d in devices]
