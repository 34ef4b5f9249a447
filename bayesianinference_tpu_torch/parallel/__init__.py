"""The parallel engines (ports of ``bayesianinference_tpu.parallel``).

Without a mesh the JAX package's mesh axis of the run-level engines is the
engine's batch, and each collective the plain reduction over it: run-level
parallel nested sampling and dynamic NS (R runs a stage), SMC ladders, HMC
with global adaptation, the ensemble's red/black sweep and IBIS.  With
``mesh=`` the runs of NS, dynamic NS and SMC split by device, and the
coupled engines (HMC, the ensemble, IBIS) run each shard's block on its
device with their per-step collectives between the shards
(:mod:`._mesh`, :class:`.sharding.ShardAxis`).

The multi-card engines run on the port's own mesh (:mod:`.sharding`: one
process drives every shard, each shard's tensors on its device, a device
may repeat): the row-sharded GP covariance, Cholesky, logML and prediction
(:mod:`.sharded_gp`, :mod:`.sharded_chol`), the data-sharded conjugate
models, the pool-sharded nested sampler and the runs x live x data nested
sampler.  ``P`` and ``NamedSharding``, JAX's placement types, are not
ported.
"""

from .multi_axis_ns import make_multi_axis_mesh, multi_axis_nested_sampling
from .parallel_dynamic_ns import parallel_dynamic_nested_sampling
from .parallel_ensemble import parallel_ensemble
from .parallel_hmc import parallel_hmc
from .parallel_ibis import parallel_ibis
from .parallel_ns import merge_runs, parallel_nested_sampling
from .parallel_smc import parallel_smc
from .sharded_chol import sharded_cholesky, sharded_gp_logml_blocked, sharded_gp_predict
from .sharded_conjugate import (
    sharded_bayesian_linear_regression,
    sharded_categorical_conjugate_model,
    sharded_multinormal_conjugate_model,
    sharded_normal_conjugate_model,
)
from .sharded_gp import sharded_covariance_matrix, sharded_gp_log_marginal_likelihood
from .sharded_pool_ns import sharded_pool_nested_sampling
from .sharding import Mesh, ShardedTensor, make_mesh, replicated, shard_data

__all__ = [
    "sharded_bayesian_linear_regression",
    "sharded_categorical_conjugate_model",
    "sharded_cholesky",
    "sharded_covariance_matrix",
    "sharded_gp_logml_blocked",
    "sharded_gp_log_marginal_likelihood",
    "sharded_gp_predict",
    "sharded_multinormal_conjugate_model",
    "sharded_normal_conjugate_model",
    "parallel_dynamic_nested_sampling",
    "parallel_ensemble",
    "parallel_hmc",
    "parallel_ibis",
    "parallel_nested_sampling",
    "parallel_smc",
    "sharded_pool_nested_sampling",
    "multi_axis_nested_sampling",
    "make_multi_axis_mesh",
    "merge_runs",
    "Mesh",
    "ShardedTensor",
    "make_mesh",
    "replicated",
    "shard_data",
]
