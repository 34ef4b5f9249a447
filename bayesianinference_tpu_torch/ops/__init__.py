"""Numerical building blocks: NS bookkeeping, the three chain kinds
(adaptive Metropolis, slice, constrained HMC), and the GP kernels (two of
them hand-written CUDA)."""

from .chmc import CHMCDraws, CHMCState, chmc_draws, run_chmc_chain
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
