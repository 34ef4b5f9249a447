"""Exact inference for linear-Gaussian state-space models (port of
``bayesianinference_tpu.ops.kalman``).

    x_1 ~ N(m0, P0),   x_t = F x_{t-1} + c + w_t,  w_t ~ N(0, Q),
    y_t = H x_t + d + v_t,                         v_t ~ N(0, R),

with the exact marginal likelihood p(y_{1:T}) from the prediction-error
decomposition.

Every function takes an explicit batch: the model's tensors may carry
leading batch axes (F [..., ds, ds], m0 [..., ds], ...) and so may the
observations (y [..., T, do]); they broadcast, and every result carries the
broadcast batch in front of its time axis.  The engines build one batched
model for all the chains of a density call.

* ``method="sequential"``: a host loop over T; each step is a handful of
  batched [..., ds, ds] products (Joseph-form covariance update), the
  ``lax.scan`` body of the JAX package.
* ``method="parallel"``: the associative filtering elements of Sarkka &
  Garcia-Fernandez (2021) under the port's own associative scan
  (:mod:`._scan`, the recursion of ``jax.lax.associative_scan``): log2(T)
  levels of batched [T, ..., ds, ds] products.

The log-likelihood is one batched pass over the predicted moments after
the filter; innovation covariances are factored by
:func:`.metropolis.small_cholesky` at every size (``cholesky_ex``, NaN
where not positive definite: the JAX package's switch to
``jnp.linalg.cholesky`` above 8 x 8 has the same result), so a non-PD
innovation from absurd hyperparameters yields NaN, which the problem
layer's guard maps to the log-zero sentinel.

Randomness is an input: :func:`kalman_sample` and
:func:`simulation_smoother` take their standard normals as
:class:`KalmanSampleDraws` (from :func:`kalman_sample_draws`, or replayed
from another run), or draw them from a ``torch.Generator``.

Missing observations: ``mask`` ([T] bool, True = observed); masked steps
propagate the prediction and add no log-likelihood.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.numerics import LOG2PI
from ._scan import associative_scan
from .metropolis import small_cholesky

__all__ = [
    "LGSSM",
    "FilterResult",
    "SmootherResult",
    "KalmanSampleDraws",
    "kalman_filter",
    "kalman_log_likelihood",
    "kalman_smoother",
    "kalman_forecast",
    "kalman_sample_draws",
    "kalman_sample",
    "simulation_smoother",
]

class LGSSM(NamedTuple):
    """Time-invariant linear-Gaussian state-space model: ``transition`` F
    [..., ds, ds], ``transition_noise`` Q [..., ds, ds], ``observation`` H
    [..., do, ds], ``observation_noise`` R [..., do, do], ``initial_mean``
    m0 [..., ds], ``initial_cov`` P0 [..., ds, ds]; optional offsets c
    [..., ds] and d [..., do]."""

    transition: torch.Tensor
    transition_noise: torch.Tensor
    observation: torch.Tensor
    observation_noise: torch.Tensor
    initial_mean: torch.Tensor
    initial_cov: torch.Tensor
    transition_offset: Optional[torch.Tensor] = None
    observation_offset: Optional[torch.Tensor] = None

    @property
    def state_dim(self) -> int:
        return self.transition.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.observation.shape[-2]

    def offsets(self):
        m0 = self.initial_mean
        c = torch.zeros_like(m0) if self.transition_offset is None else self.transition_offset
        d = (m0.new_zeros(m0.shape[:-1] + (self.obs_dim,)) if self.observation_offset is None
             else self.observation_offset)
        return c, d


class FilterResult(NamedTuple):
    """Filtered and one-step-ahead predicted moments and the exact marginal
    log-likelihood: ``predicted_*`` are p(x_t | y_{1:t-1}), ``filtered_*``
    p(x_t | y_{1:t})."""

    log_likelihood: torch.Tensor  # [...]
    filtered_means: torch.Tensor  # [..., T, ds]
    filtered_covs: torch.Tensor  # [..., T, ds, ds]
    predicted_means: torch.Tensor  # [..., T, ds]
    predicted_covs: torch.Tensor  # [..., T, ds, ds]


class SmootherResult(NamedTuple):
    """RTS-smoothed marginals p(x_t | y_{1:T})."""

    means: torch.Tensor  # [..., T, ds]
    covs: torch.Tensor  # [..., T, ds, ds]


class KalmanSampleDraws(NamedTuple):
    """Standard normals of :func:`kalman_sample`: ``initial`` [..., ds] for
    x_1, ``states`` [..., T, ds] for the transitions (row 0 unused: x_1
    draws from N(m0, P0)), ``observations`` [..., T, do]."""

    initial: torch.Tensor
    states: torch.Tensor
    observations: torch.Tensor


def _sym(a):
    return 0.5 * (a + a.mT)


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _solve_psd(s, b):
    """Solve s x = b for symmetric positive definite s through its factor."""
    l = small_cholesky(s)
    z = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(l.mT, z, upper=True)


def _prepare(model: LGSSM, y, mask):
    ref = model.transition
    y = torch.as_tensor(y, dtype=ref.dtype, device=ref.device)
    if y.dim() == 1:
        y = y[:, None]
    if y.shape[-1] != model.obs_dim:
        raise ValueError(f"y has observation dim {y.shape[-1]}, model {model.obs_dim}")
    t = y.shape[-2]
    if mask is None:
        mask_f = torch.ones((t,), dtype=ref.dtype, device=ref.device)
    else:
        mask_f = torch.as_tensor(mask, device=ref.device).to(ref.dtype)
    # zero-fill missing observations so masked arithmetic stays finite
    y = torch.where(mask_f[:, None] > 0, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y, mask_f


def _batch_shape(model: LGSSM, y) -> torch.Size:
    c, d = model.offsets()
    return torch.broadcast_shapes(
        model.transition.shape[:-2], model.transition_noise.shape[:-2], model.observation.shape[:-2],
        model.observation_noise.shape[:-2], model.initial_mean.shape[:-1], model.initial_cov.shape[:-2],
        c.shape[:-1], d.shape[:-1], y.shape[:-2])


def _predict_from(model: LGSSM, m, v):
    """(m, V) filtered at t-1 -> predicted at t; ``m`` [..., ds] and ``v``
    [..., ds, ds] may carry more leading axes than the model."""
    f = model.transition
    c, _ = model.offsets()
    return _mv(f, m) + c, _sym(f @ v @ f.mT + model.transition_noise)


def _loglik_terms(model: LGSSM, y, mask_f, pred_means, pred_covs):
    """Innovation log-densities of all steps from the predicted moments, one
    batched factorization pass of [..., T, do, do]."""
    h = model.observation[..., None, :, :]
    _, d = model.offsets()
    do = model.obs_dim
    mu = _mv(h, pred_means) + d[..., None, :]
    s = _sym(h @ pred_covs @ h.mT + model.observation_noise[..., None, :, :])
    ls = small_cholesky(s)
    z = torch.linalg.solve_triangular(ls, (y - mu)[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)), dim=-1)
    ll_t = -0.5 * (do * LOG2PI + logdet + torch.sum(z * z, dim=-1))
    return torch.sum(ll_t * mask_f, dim=-1)


def _filter_sequential(model: LGSSM, y, mask_f) -> FilterResult:
    f, h = model.transition, model.observation
    q, r = model.transition_noise, model.observation_noise
    c, d = model.offsets()
    ds = model.state_dim
    batch = _batch_shape(model, y)
    eye = torch.eye(ds, dtype=f.dtype, device=f.device)
    ms, vs, preds, pcovs = [], [], [], []
    m = v = None
    for t in range(y.shape[-2]):
        if t == 0:
            a = model.initial_mean.expand(batch + (ds,))
            p = _sym(model.initial_cov).expand(batch + (ds, ds))
        else:
            a = _mv(f, m) + c
            p = _sym(f @ v @ f.mT + q)
        s = _sym(h @ p @ h.mT + r)
        k = _solve_psd(s, h @ p).mT * mask_f[t]  # masked step: no update
        m = a + _mv(k, y[..., t, :] - _mv(h, a) - d)
        ikh = eye - k @ h
        v = _sym(ikh @ p @ ikh.mT + k @ r @ k.mT)  # Joseph form
        ms.append(m)
        vs.append(v)
        preds.append(a)
        pcovs.append(p)
    preds, pcovs = torch.stack(preds, dim=-2), torch.stack(pcovs, dim=-3)
    ll = _loglik_terms(model, y, mask_f, preds, pcovs)
    return FilterResult(ll, torch.stack(ms, dim=-2), torch.stack(vs, dim=-3), preds, pcovs)


def _kalman_combine(left, right):
    """Combine of two filtering elements (A, b, C, eta, J), the earlier one
    on the left (Sarkka & Garcia-Fernandez 2021, eqs. 13-14)."""
    a1, b1, c1, e1, j1 = left
    a2, b2, c2, e2, j2 = right
    eye_b = torch.eye(c1.shape[-1], dtype=c1.dtype, device=c1.device).expand(c1.shape)
    g = torch.linalg.solve(eye_b + c1 @ j2, torch.cat([b1[..., None] + c1 @ e2[..., None], c1], dim=-1))
    gb, gc = g[..., 0], g[..., 1:]
    a = a2 @ (eye_b - torch.linalg.solve(eye_b + c1 @ j2, c1 @ j2)) @ a1
    b = (a2 @ gb[..., None])[..., 0] + b2
    cc = _sym(a2 @ gc @ a2.mT + c2)
    ht = torch.linalg.solve((eye_b + c1 @ j2).mT, torch.cat([e2[..., None] - j2 @ b1[..., None], j2], dim=-1))
    e = (a1.mT @ ht[..., 0][..., None])[..., 0] + e1
    jj = _sym(a1.mT @ ht[..., 1:] @ a1 + j1)
    return [a, b, cc, e, jj]


def _filter_parallel(model: LGSSM, y, mask_f) -> FilterResult:
    """Element t maps N(x_{t-1}) to the filtered law at t, parameterized as
    (A, b, C, eta, J); masked steps contribute the pure prediction element.
    The scan runs with the time axis first: elements [T, ..., ds(, ds)]."""
    f, h = model.transition, model.observation
    q, r = model.transition_noise, model.observation_noise
    c, d = model.offsets()
    ds = model.state_dim
    t_total = y.shape[-2]
    batch = _batch_shape(model, y)
    eye = torch.eye(ds, dtype=f.dtype, device=f.device)

    # generic element for t >= 2 (prediction from x_{t-1}, then update)
    s = _sym(h @ q @ h.mT + r)
    k = _solve_psd(s, h @ q).mT  # gain on the predictive noise [..., ds, do]
    a_upd = (eye - k @ h) @ f
    c_upd = _sym((eye - k @ h) @ q)
    hs = _solve_psd(s, h)  # S^-1 H [..., do, ds]
    resid = y - (_mv(h, c) + d)[..., None, :]  # [..., T, do]
    b_upd = c[..., None, :] + resid @ k.mT  # [..., T, ds]
    eta = (resid @ hs) @ f
    j = _sym(f.mT @ (h.mT @ hs) @ f)

    nb = len(batch)
    wv = (mask_f > 0).reshape((t_total,) + (1,) * nb + (1,))
    wm = wv[..., None]
    time_first = lambda x: torch.movedim(x.expand(batch + x.shape[-2:]), -2, 0)  # noqa: E731
    b_all = torch.where(wv, time_first(b_upd), c.expand(batch + (ds,)))
    a_all = torch.where(wm, a_upd, f).expand((t_total,) + batch + (ds, ds))
    c_all = torch.where(wm, c_upd, q).expand((t_total,) + batch + (ds, ds))
    eta_all = torch.where(wv, time_first(eta), torch.zeros((), dtype=f.dtype, device=f.device))
    j_all = torch.where(wm, j, torch.zeros((), dtype=f.dtype, device=f.device)).expand(
        (t_total,) + batch + (ds, ds))

    # element 1: the exact first-step filter (A = 0; b, C the filtered moments)
    m0, p0 = model.initial_mean, model.initial_cov
    s1 = _sym(h @ p0 @ h.mT + r)
    k1 = _solve_psd(s1, h @ p0).mT * mask_f[0]
    m1 = m0 + _mv(k1, y[..., 0, :] - _mv(h, m0) - d)
    ikh1 = eye - k1 @ h
    v1 = _sym(ikh1 @ p0 @ ikh1.mT + k1 @ r @ k1.mT)
    zeros_m = torch.zeros((1,) + batch + (ds, ds), dtype=f.dtype, device=f.device)
    first = lambda x, shape: x.expand(batch + shape)[None]  # noqa: E731
    elems = [
        torch.cat([zeros_m, a_all[1:]]),
        torch.cat([first(m1, (ds,)), b_all[1:]]),
        torch.cat([first(v1, (ds, ds)), c_all[1:]]),
        torch.cat([torch.zeros((1,) + batch + (ds,), dtype=f.dtype, device=f.device), eta_all[1:]]),
        torch.cat([zeros_m, j_all[1:]]),
    ]
    _, b_s, c_s, _, _ = associative_scan(_kalman_combine, elems)
    ms, vs = b_s, _sym(c_s)

    # one-step-ahead predictions for the likelihood, batched
    a_prev, p_prev = _predict_from(model, ms[:-1], vs[:-1])
    preds = torch.cat([first(m0, (ds,)), a_prev])
    pcovs = torch.cat([first(p0, (ds, ds)), p_prev])
    ms, vs = torch.movedim(ms, 0, -2), torch.movedim(vs, 0, -3)
    preds, pcovs = torch.movedim(preds, 0, -2), torch.movedim(pcovs, 0, -3)
    ll = _loglik_terms(model, y, mask_f, preds, pcovs)
    return FilterResult(ll, ms, vs, preds, pcovs)


def kalman_filter(model: LGSSM, y, mask=None, method: str = "sequential") -> FilterResult:
    """Run the Kalman filter: ``method="sequential"`` (a host loop over T)
    or ``"parallel"`` (the associative scan, log-depth in T)."""
    y, mask_f = _prepare(model, y, mask)
    if method == "sequential":
        return _filter_sequential(model, y, mask_f)
    if method == "parallel":
        return _filter_parallel(model, y, mask_f)
    raise ValueError(f"unknown filter method {method!r}")


def kalman_log_likelihood(model: LGSSM, y, mask=None, method: str = "sequential") -> torch.Tensor:
    """Exact marginal log-likelihood p(y_{1:T}) [...]."""
    return kalman_filter(model, y, mask, method).log_likelihood


def kalman_smoother(model: LGSSM, y, mask=None, method: str = "sequential") -> SmootherResult:
    """RTS smoother: p(x_t | y_{1:T}) from a filter pass and one reverse
    host loop of [..., ds, ds] products."""
    fr = kalman_filter(model, y, mask, method)
    f = model.transition
    m_next, v_next = fr.filtered_means[..., -1, :], fr.filtered_covs[..., -1, :, :]
    ms, vs = [m_next], [v_next]
    for t in range(fr.filtered_means.shape[-2] - 2, -1, -1):
        m_f, v_f = fr.filtered_means[..., t, :], fr.filtered_covs[..., t, :, :]
        a_next, p_next = fr.predicted_means[..., t + 1, :], fr.predicted_covs[..., t + 1, :, :]
        g = _solve_psd(p_next, f @ v_f).mT  # smoother gain [..., ds, ds]
        m_next = m_f + _mv(g, m_next - a_next)
        v_next = _sym(v_f + g @ (v_next - p_next) @ g.mT)
        ms.append(m_next)
        vs.append(v_next)
    return SmootherResult(torch.stack(ms[::-1], dim=-2), torch.stack(vs[::-1], dim=-3))


def kalman_forecast(model: LGSSM, filter_result: FilterResult, steps: int):
    """h-step-ahead forecast of the observations from the last filtered
    state: (means [..., steps, do], covs [..., steps, do, do])."""
    h = model.observation
    _, d = model.offsets()
    m, v = filter_result.filtered_means[..., -1, :], filter_result.filtered_covs[..., -1, :, :]
    my, vy = [], []
    for _ in range(steps):
        m, v = _predict_from(model, m, v)
        my.append(_mv(h, m) + d)
        vy.append(_sym(h @ v @ h.mT + model.observation_noise))
    return torch.stack(my, dim=-2), torch.stack(vy, dim=-3)


def _psd_sqrt(a):
    """Symmetric square root of a PSD matrix by ``eigh``: structural models
    have singular process noise, where a Cholesky would fail."""
    w, v = torch.linalg.eigh(_sym(a))
    return v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


def kalman_sample_draws(generator: torch.Generator, model: LGSSM, num_steps: int, shape=()) -> KalmanSampleDraws:
    """The standard normals of :func:`kalman_sample`, with leading ``shape``
    (one set per sampled series)."""
    ref = model.transition
    kw = dict(generator=generator, dtype=ref.dtype, device=ref.device)
    shape = tuple(shape)
    return KalmanSampleDraws(
        initial=torch.randn(shape + (model.state_dim,), **kw),
        states=torch.randn(shape + (num_steps, model.state_dim), **kw),
        observations=torch.randn(shape + (num_steps, model.obs_dim), **kw),
    )


def kalman_sample(generator: Optional[torch.Generator], model: LGSSM, num_steps: int,
                  draws: Optional[KalmanSampleDraws] = None):
    """Simulate (states [..., T, ds], observations [..., T, do]) from the
    model, with ``draws`` (leading axes broadcasting against the model's
    batch) or normals from ``generator``."""
    if draws is None:
        draws = kalman_sample_draws(generator, model, num_steps)
    c, d = model.offsets()
    lq = _psd_sqrt(model.transition_noise)
    lr = _psd_sqrt(model.observation_noise)
    l0 = _psd_sqrt(model.initial_cov)
    x = model.initial_mean + _mv(l0, draws.initial)
    xs = [x]
    # x_1 draws from N(m0, P0) directly; transitions start at t = 2
    for t in range(1, num_steps):
        x = _mv(model.transition, x) + c + _mv(lq, draws.states[..., t, :])
        xs.append(x)
    xs = torch.stack(xs, dim=-2)
    ys = xs @ model.observation.mT + d[..., None, :] + draws.observations @ lr.mT
    return xs, ys


def _lift(model: LGSSM) -> LGSSM:
    """The model with a new batch axis of size 1 last among its batch axes."""
    def up(x, event):
        return None if x is None else x.unsqueeze(-event - 1)

    return LGSSM(*(up(x, e) for x, e in zip(model, (2, 2, 2, 2, 1, 2, 1, 1))))


def simulation_smoother(
    generator: Optional[torch.Generator],
    model: LGSSM,
    y,
    num_draws: int,
    mask=None,
    method: str = "sequential",
    draws: Optional[KalmanSampleDraws] = None,
):
    """Joint posterior draws of the state path, x_{1:T} ~ p(x | y), by the
    mean-correction simulation smoother of Durbin & Koopman (2002): simulate
    (x*, y*) from the prior, then ``x* + E[x | y] - E[x | y*]`` is an exact
    draw.  The data smoother pass is computed once; the ``num_draws``
    pseudo-data smoother passes run as one batch.

    Returns [..., num_draws, T, ds], ``...`` the model's batch axes.
    ``draws`` are the :class:`KalmanSampleDraws` of the draws (leading
    axes [..., num_draws]); without them normals come from ``generator``."""
    ref = model.transition
    y = torch.as_tensor(y, dtype=ref.dtype, device=ref.device)
    if y.dim() == 1:
        y = y[:, None]
    t_total = y.shape[-2]
    m_smooth = kalman_smoother(model, y, mask, method).means.unsqueeze(-3)
    lifted = _lift(model)
    if draws is None:
        batch = _batch_shape(model, y)
        draws = kalman_sample_draws(generator, model, t_total, batch + (num_draws,))
    xs, ys = kalman_sample(None, lifted, t_total, draws)
    m_star = kalman_smoother(lifted, ys, mask, method).means
    return xs + m_smooth - m_star
