"""The parallel engines on one card: runs, chains, walkers or particles
folded into one batch (ports of ``bayesianinference_tpu.parallel``).

Each JAX engine here is a single-device engine with its mesh axis turned
into a ``shard_map``; on one card that axis is the engine's batch, and
each collective the plain reduction over it: run-level parallel nested
sampling and dynamic NS (R runs a stage), SMC ladders, HMC with global
adaptation, the ensemble's red/black sweep and IBIS.  Every ``mesh=``
raises.  The JAX package's sharded engines over several cards
(``sharded_*``, ``multi_axis_*`` and the mesh helpers) are not ported
yet (ROADMAP queue 1 item 7)."""

from .parallel_dynamic_ns import parallel_dynamic_nested_sampling
from .parallel_ensemble import parallel_ensemble
from .parallel_hmc import parallel_hmc
from .parallel_ibis import parallel_ibis
from .parallel_ns import merge_runs, parallel_nested_sampling
from .parallel_smc import parallel_smc

__all__ = [
    "merge_runs",
    "parallel_dynamic_nested_sampling",
    "parallel_ensemble",
    "parallel_hmc",
    "parallel_ibis",
    "parallel_nested_sampling",
    "parallel_smc",
]
