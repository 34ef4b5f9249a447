"""Numerical building blocks: NS bookkeeping, the chain kinds (adaptive
Metropolis, slice, constrained HMC, HMC with fixed and ChEES trajectories,
the ensemble moves), and the GP kernels (two of them hand-written CUDA)."""

from .chees import ChEESDraws, chees_draws, chees_warmup_and_sample, halton_base2
from .chmc import CHMCDraws, CHMCState, chmc_draws, run_chmc_chain
from .ensemble import DEDraws, EnsembleState, StretchDraws, ensemble_draws, ensemble_init, ensemble_sweep
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
from .slice import SliceDraws, SliceState, run_slice_chain, slice_draws, slice_init, slice_update
