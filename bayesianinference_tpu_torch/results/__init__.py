"""Post-processing of sampler output: the convergence diagnostics.  The
rest of the JAX package's ``results/`` is not ported yet."""

from .diagnostics import autocorrelation, effective_sample_size, gelman_rubin, weighted_effective_sample_size

__all__ = ["autocorrelation", "effective_sample_size", "gelman_rubin", "weighted_effective_sample_size"]
