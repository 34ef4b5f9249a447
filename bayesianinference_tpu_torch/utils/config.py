"""Typed option bundles with the reference's defaults (port of
``bayesianinference_tpu.utils.config``): frozen dataclasses that can be
passed down to the engines."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

__all__ = ["NestedSamplingOptions", "EvidenceOptions", "MCMCOptions"]


@dataclasses.dataclass(frozen=True)
class EvidenceOptions:
    """The options of evidence resampling."""

    post_process_sampling_runs: Optional[int] = 100
    empirical_posterior_distribution_type: str = "Simple"


@dataclasses.dataclass(frozen=True)
class NestedSamplingOptions(EvidenceOptions):
    """The options of nested sampling and of its loop."""

    sample_pool_size: int = 100
    max_iterations: int = 10000
    min_iterations: int = 100
    monte_carlo_steps: Union[int, Tuple[int, int, int]] = 200
    termination_fraction: float = 0.01
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0)
    log_likelihood_maximum: Optional[float] = None
    num_delete: int = 1  # chains per iteration

    def loop_kwargs(self) -> dict:
        """Keyword arguments of ``engines.nested_sampling.nested_sampling_loop``."""
        return dict(
            max_iterations=self.max_iterations,
            min_iterations=self.min_iterations,
            monte_carlo_steps=self.monte_carlo_steps,
            termination_fraction=self.termination_fraction,
            num_delete=self.num_delete,
            min_max_acceptance_rate=self.min_max_acceptance_rate,
            log_likelihood_maximum=self.log_likelihood_maximum,
        )


@dataclasses.dataclass(frozen=True)
class MCMCOptions:
    """The options of ``engines.mcmc.create_mcmc_chain`` and of starting-point
    generation."""

    initial_covariance: float = 1.0
    covariance_learn_delay: int = 20
    burn_in_period: int = 1000
    thinning: int = 1000
