"""Numerical building blocks: NS bookkeeping, the chain kinds (adaptive
Metropolis, slice, constrained HMC, HMC with fixed and ChEES trajectories,
the ensemble moves, elliptical slice), the GP kernels (two of them
hand-written CUDA) and the latent-GP, sparse-GP, Student-t-process and
multi-output GP numerics built on them."""

from .chees import ChEESDraws, chees_draws, chees_warmup_and_sample, halton_base2
from .chmc import CHMCDraws, CHMCState, chmc_draws, run_chmc_chain
from .ess import ESSDraws, EllipticalState, ess_draws, ess_init, ess_sample, ess_update, run_ess_chain
from .ensemble import DEDraws, EnsembleState, StretchDraws, ensemble_draws, ensemble_init, ensemble_sweep
from .gp_kernels import (
    Kernel,
    constant_kernel,
    covariance_matrix,
    gp_log_marginal_likelihood,
    gp_posterior_moments,
    linear_kernel,
    matern12_kernel,
    matern32_kernel,
    matern52_kernel,
    periodic_kernel,
    rational_quadratic_kernel,
    se_kernel,
    squared_distances,
    white_kernel,
)
from .gp_ep import EPState, gp_ep_latent_moments, gp_ep_log_marginal, gp_ep_state
from .gp_laplace import (
    LatentLikelihood,
    bernoulli_logit_likelihood,
    bernoulli_probit_likelihood,
    binomial_logit_likelihood,
    gamma_log_likelihood,
    gauss_hermite_expectation,
    gp_laplace_latent_moments,
    gp_laplace_log_marginal,
    gp_laplace_mode,
    latent_likelihood,
    negative_binomial_likelihood,
    ordinal_logit_likelihood,
    poisson_log_likelihood,
)
from .hmc import (
    DAState,
    HMCDraws,
    HMCState,
    dual_averaging_init,
    dual_averaging_update,
    hmc_draws,
    hmc_init,
    hmc_step,
    leapfrog,
    momentum_factor,
    warmup_and_sample,
)
from .metropolis import (
    AMState,
    am_block,
    am_draws,
    am_init,
    am_step,
    am_step_draws,
    chol_rank1_update,
    proposal_chol,
    run_chain,
    run_chain_adaptive,
    small_cholesky,
    welford_absorb,
    welford_absorb_chol,
)
from .ns_math import (
    crude_log_x_deleted,
    entropy_from_weights,
    log_trapezoid_weights,
    log_x_live_tail,
    pool_schedule,
)
from .mogp import (
    coregional_matrix,
    mogp_covariance,
    mogp_log_marginal_kronecker,
    mogp_log_marginal_likelihood,
    mogp_posterior_moments,
)
from .sgpr import (
    SGPRState,
    sgpr_bound,
    sgpr_data_stats,
    sgpr_kuu_inv_chol,
    sgpr_predict,
    sgpr_state,
    sgpr_state_from_stats,
)
from .svgp import (
    SVGPVariational,
    svgp_elbo,
    svgp_expected_loglik,
    svgp_hetero_elbo,
    svgp_init_variational,
    svgp_kl,
    svgp_latent_moments,
    svgp_multiclass_elbo,
    svgp_multiclass_latent_moments,
)
from .slice import SliceDraws, SliceState, run_slice_chain, slice_draws, slice_init, slice_update
from .t_process import tp_log_marginal_likelihood, tp_posterior_moments
