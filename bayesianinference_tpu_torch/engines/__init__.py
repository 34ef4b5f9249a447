"""Inference engines: nested sampling (static and dynamic) with its
checkpoints, evidence resampling, the Markov-chain API, GP regression and
the Laplace approximation.  ``nested_sampling`` stays in its module
(``engines.nested_sampling``): a package attribute of that name would hide
the module."""

from .checkpoint import load_ns_run, load_result, resume_nested_sampling_loop, save_ns_run, save_result
from .dynamic_ns import (
    NSSegment,
    dynamic_nested_sampling,
    merge_segments,
    merged_evidence_sampling,
    segment_from_run,
)
from .gp import coordinate_bounds_grid, define_gaussian_process, predict_from_gaussian_process
from .laplace import (
    LaplaceFit,
    approximate_evidence,
    approximate_evidence_hyper,
    find_mode,
    fit_precision_at_max,
    laplace_log_evidence,
    laplace_posterior_fit,
    mackay_update_1,
    mackay_update_2,
)
from .mcmc import MCMCChain, create_mcmc_chain, iterate_mcmc
