"""Runs in parallel: run-level parallel nested sampling on one card.

The JAX package's other parallel engines (dynamic NS, HMC, SMC, ensemble
and IBIS runs, and the sharded engines over a mesh) are not ported yet."""

from .parallel_ns import merge_runs, parallel_nested_sampling

__all__ = ["merge_runs", "parallel_nested_sampling"]
