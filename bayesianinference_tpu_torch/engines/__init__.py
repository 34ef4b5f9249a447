"""Inference engines: nested sampling (static and dynamic) with its
checkpoints, evidence resampling, the Markov-chain API, GP regression
(dense, sparse, Student-t, multi-output) and latent-GP classification,
the stochastic variational GP, Bayesian optimization, the Laplace
approximation, the conjugate models, direct quadrature, HMC,
tempered SMC, the affine-invariant ensemble, ADVI, RealNVP flow VI,
Pathfinder and bridge-sampling evidence; the time-series engines (state-space
models, hidden Markov models, changepoints, PMMH and IBIS).  ``nested_sampling`` stays in its module
(``engines.nested_sampling``): a package attribute of that name would hide
the module."""

from .bayesopt import (
    BayesOptConfig,
    BayesOptResult,
    BayesOptState,
    BODraws,
    DesignDraws,
    bayes_optimize,
    bo_draws,
    bo_init,
    bo_observe,
    bo_suggest,
    design_draws,
)
from .bridge import BridgeResult, bridge_sampling_evidence
from .checkpoint import load_ns_run, load_result, resume_nested_sampling_loop, save_ns_run, save_result
from .conjugate import (
    BLRParameters,
    BLRResult,
    ConjugateModelResult,
    bayesian_linear_regression,
    categorical_conjugate_model,
    categorical_conjugate_model_from_counts,
    design_matrix,
    multinormal_conjugate_model,
    normal_conjugate_model,
    polynomial_basis,
    update_conjugate_model,
)
from .ensemble import EnsembleResult, ensemble_sample
from .flow_vi import FlowVIResult, flow_vi_fit
from .evidence import MeanAndError, NestedSamplingResult, combine_runs, evidence_sampling, log_bayes_factor
from .direct import DirectPosterior, direct_posterior_distribution, gauss_legendre_grid
from .dynamic_ns import (
    NSSegment,
    dynamic_nested_sampling,
    merge_segments,
    merged_evidence_sampling,
    segment_from_run,
)
from .hmc import HMCResult, hmc_sample
from .gp import GPModel, coordinate_bounds_grid, define_gaussian_process, predict_from_gaussian_process
from .gp_classify import (
    GPClassifierModel,
    GPClassifierOptimization,
    GPClassPrediction,
    GPLatentDraws,
    GPLatentSamples,
    define_gp_classifier,
    gp_latent_draws,
    latent_draws_at,
    optimize_gp_classifier,
    predict_from_gp_classifier,
    sample_gp_latents,
)
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
from .nested_sampling import NSState, generate_starting_points, nested_sampling_loop
from .mogp import MOGPModel, define_multi_output_gp, predict_from_multi_output_gp
from .pathfinder import PathfinderDraws, PathfinderResult, pathfinder_draws, pathfinder_fit
from .smc import SMCConfig, SMCResult, smc_log_evidence, smc_sampler, thermodynamic_log_evidence
from .sparse_gp import (
    SGPRModel,
    SGPROptimization,
    define_sparse_gaussian_process,
    optimize_sparse_gp,
    select_inducing_points,
)
from .svgp import (
    SVGPDraws,
    SVGPFit,
    SVGPHeteroFit,
    SVGPMulticlassFit,
    fit_svgp,
    fit_svgp_heteroscedastic,
    fit_svgp_multiclass,
    predict_from_svgp,
    predict_from_svgp_heteroscedastic,
    predict_from_svgp_multiclass,
    svgp_draws,
)
from .t_process import TPModel, define_t_process, predict_from_t_process
from .vi import VIDraws, VIResult, advi_fit, vi_draws
from .changepoint import changepoint_probability, define_changepoint_model, run_length_posterior
from .hmm import (
    define_hidden_markov_model,
    forecast_regime_probabilities,
    most_likely_states,
    regime_probabilities,
    sample_hidden_paths,
)
from .ibis import IBISResult, IBISStageDraws, ibis_sampler, ibis_stage_draws
from .particle import PMMHDraws, PMMHResult, pmmh_draws, pmmh_sample
from .ssm import (
    SSMComponent,
    ar_component,
    define_state_space_model,
    forecast_observations,
    level_component,
    sample_state_paths,
    seasonal_component,
    smoothed_states,
    structural_lgssm,
    trend_component,
)
