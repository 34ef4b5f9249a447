"""Exact inference for discrete-state hidden Markov models (port of
``bayesianinference_tpu.ops.hmm``).

    z_1 ~ Cat(pi),   z_t | z_{t-1} ~ Cat(A[z_{t-1}]),   y_t | z_t ~ p(y | z_t),

with p(y_{1:T}) summed exactly over all K^T paths by the forward
algorithm.  Emissions enter as ``log_obs`` [..., T, K], the per-step
per-state observation log-densities.

Every function takes an explicit batch: ``initial_log_probs`` [..., K],
``transition_log_probs`` [..., K, K] and ``log_obs`` [..., T, K] broadcast.

* ``method="sequential"``: a host loop over T in log space, each step a
  [..., K, K] broadcast and log-sum-exp.
* ``method="parallel"``: the forward recursion as a chain of [K, K]
  products under the port's associative scan (:mod:`._scan`), each element
  carrying a log-norm so the linear-domain products stay in range.

Missing observations: ``mask`` ([T] bool, True = observed) drops the
emission factor.  Categorical draws are ``argmax(logits + gumbel)``, as
``jax.random.categorical`` draws them; the Gumbel noise is an input
(:func:`hmm_gumbels`) or comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.numerics import filter_logsumexp, logsumexp
from ._scan import associative_scan

__all__ = [
    "HMM",
    "HMMFilterResult",
    "hmm_gumbels",
    "hmm_log_likelihood",
    "hmm_filter",
    "hmm_smoother",
    "hmm_viterbi",
    "hmm_forecast",
    "hmm_posterior_sample",
    "hmm_sample_states",
    "row_stochastic",
]


class HMM(NamedTuple):
    """Chain parameters in log space: ``initial_log_probs`` log pi [..., K],
    ``transition_log_probs`` log A [..., K, K] with A[i, j] = p(z_t = j |
    z_{t-1} = i).  Build rows with :func:`row_stochastic`."""

    initial_log_probs: torch.Tensor
    transition_log_probs: torch.Tensor

    @property
    def num_states(self) -> int:
        return self.transition_log_probs.shape[-1]


class HMMFilterResult(NamedTuple):
    """``log_filtered`` [..., T, K] = log p(z_t | y_{1:t}) and the exact
    marginal ``log_likelihood`` [...]."""

    log_likelihood: torch.Tensor
    log_filtered: torch.Tensor


def _masked(log_obs, mask):
    if mask is None:
        return log_obs
    m = torch.as_tensor(mask, device=log_obs.device).to(log_obs.dtype)
    return log_obs * m[:, None]  # masked step: no emission factor


def _seq_forward(hmm: HMM, obs):
    log_a = hmm.transition_log_probs
    a = hmm.initial_log_probs + obs[..., 0, :]
    acc = filter_logsumexp(a, dim=-1)
    alpha = a - acc[..., None]
    alphas = [alpha]
    for t in range(1, obs.shape[-2]):
        a = filter_logsumexp(alpha[..., :, None] + log_a, dim=-2) + obs[..., t, :]
        c = filter_logsumexp(a, dim=-1)
        alpha = a - c[..., None]
        acc = acc + c
        alphas.append(alpha)
    return torch.stack(alphas, dim=-2), acc


def _par_forward(hmm: HMM, obs):
    """All filtered prefixes in log2(T) levels of batched [K, K] products.
    Element (M, c) stands for exp(c) M; the combine
    (M1, c1)(M2, c2) -> (normalize(M1 M2), c1 + c2 + log norm) is exact on
    representations, so the normalization keeps associativity."""
    log_a = hmm.transition_log_probs
    batch = torch.broadcast_shapes(hmm.initial_log_probs.shape[:-1], log_a.shape[:-2], obs.shape[:-2])
    obs = obs.expand(batch + obs.shape[-2:])  # the time axis goes first below
    a0 = hmm.initial_log_probs + obs[..., 0, :]
    c0 = logsumexp(a0, dim=-1)
    a0n = torch.exp(a0 - c0[..., None])
    # elements for t = 1..T-1: M_t[i, j] = A[i, j] b_t(j) / exp(m_t), time first
    rest = torch.movedim(obs[..., 1:, :], -2, 0)
    mt = torch.amax(rest, dim=-1)
    els = torch.exp(log_a + (rest - mt[..., None])[..., None, :])
    tiny = torch.finfo(obs.dtype).tiny

    def combine(x, y):
        m1, c1 = x
        m2, c2 = y
        p = m1 @ m2
        n = torch.clamp(torch.amax(p, dim=(-2, -1), keepdim=True), min=tiny)
        return [p / n, c1 + c2 + torch.log(n[..., 0, 0])]

    prods, cs = associative_scan(combine, [els, mt])
    av = (a0n[..., None, :] @ prods)[..., 0, :]  # alpha_t = a0n P_t, [T-1, ..., K]
    norm = torch.sum(av, dim=-1)
    log_alpha = torch.log(torch.clamp(av, min=tiny) / torch.clamp(norm, min=tiny)[..., None])
    ll = c0 + cs[-1] + torch.log(torch.clamp(norm[-1], min=tiny))
    la = torch.cat([(a0 - c0[..., None]).expand(log_alpha.shape[1:])[None], log_alpha])
    return torch.movedim(la, 0, -2), ll


def hmm_filter(hmm: HMM, log_obs, mask=None, method: str = "sequential") -> HMMFilterResult:
    """Forward algorithm: normalized filtered log-probabilities and the
    exact marginal log-likelihood."""
    obs = _masked(torch.as_tensor(log_obs), mask)
    if method == "sequential":
        la, ll = _seq_forward(hmm, obs)
    elif method == "parallel":
        la, ll = _par_forward(hmm, obs)
    else:
        raise ValueError(f"unknown method {method!r}")
    return HMMFilterResult(log_likelihood=ll, log_filtered=la)


def hmm_log_likelihood(hmm: HMM, log_obs, mask=None, method: str = "sequential"):
    """Exact log p(y_{1:T}) = log sum over all K^T hidden paths."""
    return hmm_filter(hmm, log_obs, mask, method).log_likelihood


def hmm_smoother(hmm: HMM, log_obs, mask=None, method: str = "sequential"):
    """Forward-backward: log p(z_t | y_{1:T}) [..., T, K]; the backward pass
    is one reverse host loop whatever ``method``."""
    obs = _masked(torch.as_tensor(log_obs), mask)
    fr = hmm_filter(hmm, obs, None, method)
    log_a = hmm.transition_log_probs
    beta = torch.zeros(fr.log_filtered.shape[:-2] + (hmm.num_states,), dtype=obs.dtype, device=obs.device)
    betas = [beta]
    for t in range(obs.shape[-2] - 1, 0, -1):
        b = filter_logsumexp(log_a + (obs[..., t, :] + beta)[..., None, :], dim=-1)
        beta = b - torch.amax(b, dim=-1, keepdim=True)
        betas.append(beta)
    g = fr.log_filtered + torch.stack(betas[::-1], dim=-2)
    return g - logsumexp(g, dim=-1, keepdim=True)


def hmm_viterbi(hmm: HMM, log_obs, mask=None):
    """Most likely hidden path argmax_z p(z_{1:T} | y_{1:T}) [..., T] int64
    (max-product forward pass, backpointer backtrace)."""
    obs = _masked(torch.as_tensor(log_obs), mask)
    log_a = hmm.transition_log_probs
    delta = hmm.initial_log_probs + obs[..., 0, :]
    psis = []
    for t in range(1, obs.shape[-2]):
        scores = delta[..., :, None] + log_a  # [from, to]
        best, arg = torch.max(scores, dim=-2)
        delta = best + obs[..., t, :]
        psis.append(arg)
    z = torch.argmax(delta, dim=-1)
    path = [z]
    for psi in reversed(psis):
        z = torch.take_along_dim(psi, z[..., None], dim=-1)[..., 0]
        path.append(z)
    return torch.stack(path[::-1], dim=-1)


def hmm_gumbels(generator: torch.Generator, shape, num_states: int, *, dtype=None, device=None) -> torch.Tensor:
    """Standard Gumbel noise [*shape, K] for the categorical draws of
    :func:`hmm_posterior_sample` and :func:`hmm_sample_states`."""
    u = torch.rand(tuple(shape) + (num_states,), generator=generator, dtype=dtype,
                   device=device if device is not None else generator.device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def hmm_posterior_sample(generator: Optional[torch.Generator], hmm: HMM, log_obs, num_draws: int, mask=None,
                         method: str = "sequential", gumbels: Optional[torch.Tensor] = None):
    """Joint posterior draws z_{1:T} ~ p(z | y) [..., num_draws, T] by
    forward filtering (once) and backward sampling of all draws as one
    batch.  ``gumbels`` [..., num_draws, T, K]: row T-1 draws z_T, row t the
    step back to z_t."""
    obs = torch.as_tensor(log_obs)
    la = hmm_filter(hmm, obs, mask, method).log_filtered.unsqueeze(-3)  # [..., 1, T, K]
    log_a = hmm.transition_log_probs.unsqueeze(-3)
    t_total = obs.shape[-2]
    if gumbels is None:
        gumbels = hmm_gumbels(generator, la.shape[:-3] + (num_draws, t_total), hmm.num_states,
                              dtype=obs.dtype, device=obs.device)
    z = torch.argmax(la[..., -1, :] + gumbels[..., -1, :], dim=-1)
    path = [z]
    for t in range(t_total - 2, -1, -1):
        col = torch.take_along_dim(log_a, z[..., None, None], dim=-1)[..., 0]  # log A[:, z_next]
        z = torch.argmax(la[..., t, :] + col + gumbels[..., t, :], dim=-1)
        path.append(z)
    return torch.stack(path[::-1], dim=-1)


def hmm_forecast(hmm: HMM, filter_result: HMMFilterResult, steps: int):
    """h-step-ahead state log-probabilities p(z_{T+h} | y_{1:T}) [...,
    steps, K]: the filtered terminal distribution pushed through the
    transition kernel h times."""
    log_a = hmm.transition_log_probs
    la = filter_result.log_filtered[..., -1, :]
    out = []
    for _ in range(steps):
        la = filter_logsumexp(la[..., :, None] + log_a, dim=-2)
        out.append(la)
    return torch.stack(out, dim=-2)


def hmm_sample_states(generator: Optional[torch.Generator], hmm: HMM, num_steps: int,
                      gumbels: Optional[torch.Tensor] = None):
    """Prior draw of one hidden path z_{1:T} [..., num_steps]; ``gumbels``
    [..., num_steps, K] (row 0 draws z_1)."""
    pi = hmm.initial_log_probs
    if gumbels is None:
        gumbels = hmm_gumbels(generator, pi.shape[:-1] + (num_steps,), hmm.num_states, dtype=pi.dtype,
                              device=pi.device)
    log_a = hmm.transition_log_probs
    z = torch.argmax(pi + gumbels[..., 0, :], dim=-1)
    zs = [z]
    for t in range(1, num_steps):
        row = torch.take_along_dim(log_a, z[..., None, None], dim=-2)[..., 0, :]  # log A[z, :]
        z = torch.argmax(row + gumbels[..., t, :], dim=-1)
        zs.append(z)
    return torch.stack(zs, dim=-1)


def row_stochastic(logits):
    """Log row-stochastic matrix from unconstrained logits [..., K, K-1]:
    each row gets an implicit last logit of 0, so K (K - 1) free parameters
    cover all transition matrices."""
    logits = torch.as_tensor(logits)
    full = torch.cat([logits, torch.zeros(logits.shape[:-1] + (1,), dtype=logits.dtype, device=logits.device)],
                     dim=-1)
    return full - logsumexp(full, dim=-1, keepdim=True)
