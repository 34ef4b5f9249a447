"""Pathfinder: parallel quasi-Newton variational inference (port of
``bayesianinference_tpu.engines.pathfinder``).

Pathfinder (Zhang, Carpenter, Gelman & Vehtari, JMLR 2022) evaluates a
Gaussian approximation at every iterate of an L-BFGS ascent of the log
posterior, with the covariance from the optimizer's compact inverse-Hessian
estimate (Byrd, Nocedal & Schnabel 1994), and keeps the iterate whose
approximation has the largest ELBO.  ``num_paths`` trajectories run as one
batch over an explicit path axis: each line-search try is one batched
value and gradient at B = ``num_paths``, so on a GP problem both hand
kernels and both reverse rules run at that batch.  The pooled draws carry
exact importance weights ``log p - log q``, Pareto-smoothed
(:func:`..results.information._psis_smooth_tail`) with the pooled k-hat
reported, and give the evidence estimate ``logsumexp(log p - log q) - log N``.

Equal to the JAX program lane for lane:

* the Armijo backtracking is a ``lax.while_loop`` under ``vmap`` there, a
  masked loop over the batch here (at most ``max_backtracks`` tries, until
  every path has accepted or stopped); a frozen path's search is discarded
  by the JAX step, so it does not search here;
* the ``lax.scan`` runs ``maxiter`` steps; once every path is frozen the
  loop here stops and records the remaining steps as the scan does (no
  move, no pair, the iterate, gradient and diagonal carried);
* the ELBO block, P x L x K density calls in one ``vmap`` there, runs the
  valid iterates only (the others are masked to -inf in both) in chunks of
  ``vi.EVAL_CHUNK`` points;
* the QR factor's signs may differ from XLA's; the draws, log-densities and
  log-determinants do not.

The random numbers are inputs: :func:`pathfinder_draws` makes the initial
points' uniforms (z-space, [-2, 2]) and each path's ELBO and final normals
(:class:`PathfinderDraws`).

Not ported, as XLA workarounds: the ``jax.jit`` program cache keyed on the
static arguments (``_pathfinder_program``) and the one-program scan (a host
loop over batched eager steps here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.containers import WeightedSamples
from ..core.numerics import logsumexp
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.chmc import _safe_grad, _value_and_grad
from .vi import in_chunks, z_log_target

__all__ = ["PathfinderDraws", "PathfinderResult", "pathfinder_draws", "pathfinder_fit"]


class PathfinderDraws(NamedTuple):
    """The random numbers of a fit: ``init`` [P, d] uniform on [-2, 2]
    (z-space starting points, unused with ``initial_points``),
    ``elbo`` [P, num_elbo_draws, d] and ``final`` [P, num_draws_per_path,
    d] standard normals."""

    init: torch.Tensor
    elbo: torch.Tensor
    final: torch.Tensor


def pathfinder_draws(generator: torch.Generator, num_paths: int, dim: int, num_elbo_draws: int = 30,
                     num_draws_per_path: int = 256, dtype=torch.float64) -> PathfinderDraws:
    """A fit's draws from ``generator`` (on its device)."""
    dev = generator.device
    init = 4.0 * torch.rand((num_paths, dim), generator=generator, dtype=dtype, device=dev) - 2.0
    elbo = torch.randn((num_paths, num_elbo_draws, dim), generator=generator, dtype=dtype, device=dev)
    final = torch.randn((num_paths, num_draws_per_path, dim), generator=generator, dtype=dtype, device=dev)
    return PathfinderDraws(init, elbo, final)


@dataclasses.dataclass(frozen=True)
class PathfinderResult:
    """Pooled multi-path Pathfinder approximation of a posterior."""

    samples: WeightedSamples  # pooled draws, PSIS-smoothed log-weights
    elbo_per_path: torch.Tensor  # [P] the winning approximation's ELBO per path
    best_iteration: torch.Tensor  # [P] iterate index that won per path
    log_evidence_is: torch.Tensor  # importance-sampling logZ estimate
    pareto_k: torch.Tensor  # pooled-weight tail diagnostic (trust < 0.7)
    path_loc: torch.Tensor  # [P, d] winning Gaussian means (z-space)
    lower: torch.Tensor  # [d] problem box (for the bijection)
    upper: torch.Tensor  # [d]
    param_names: Tuple[str, ...] = ()

    @property
    def elbo(self) -> torch.Tensor:
        """Best single-path ELBO: a lower bound on log evidence."""
        return torch.max(self.elbo_per_path)

    @property
    def num_paths(self) -> int:
        return self.elbo_per_path.shape[0]

    def posterior_samples(self, generator: Optional[torch.Generator], num_samples: int = 4000, *,
                          indices: Optional[torch.Tensor] = None) -> WeightedSamples:
        """Equal-weight draws resampled by the smoothed importance weights;
        ``indices`` [num_samples] replaces the generator's choice."""
        if indices is None:
            w = self.samples.normalized_weights()
            indices = torch.multinomial(w, num_samples, replacement=True, generator=generator)
        pts = self.samples.points[torch.as_tensor(indices, device=self.samples.points.device)]
        return WeightedSamples(points=pts, log_weights=torch.zeros((pts.shape[0],), dtype=pts.dtype,
                                                                  device=pts.device))


# ---------------------------------------------------------------------------
# L-BFGS trajectories over a path axis (every iterate and pair recorded)
# ---------------------------------------------------------------------------


class Trajectory(NamedTuple):
    """``iterates``/``grads``/``alphas`` [P, L+1, d] (``alphas[:, l]`` the
    diagonal inverse-Hessian estimate at iterate l), ``pair_s``/``pair_y``
    [P, L, d], ``pair_ok`` [P, L], ``valid`` [P, L+1] (iterates that
    moved; iterate 0 is valid)."""

    iterates: torch.Tensor
    grads: torch.Tensor
    alphas: torch.Tensor
    pair_s: torch.Tensor
    pair_y: torch.Tensor
    pair_ok: torch.Tensor
    valid: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def lbfgs_trajectories(value_and_grad: Callable, z0: torch.Tensor, *, maxiter: int, history: int, tol: float,
                       max_backtracks: int = 24) -> Trajectory:
    """Minimize ``f`` from each row of ``z0`` [P, d], recording the paths.
    ``value_and_grad(z [P, d]) -> (f [P], grad [P, d])``."""
    P, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    J = history
    eps_curv = 1e-11 if dtype == torch.float64 else 1e-7
    rows = torch.arange(P, device=dev)
    c1 = 1e-4

    def two_loop(g, S, Y, rho, ptr, count, alpha):
        """Two-loop recursion with the rolling [P, J, d] history; the
        newest pair sits at (ptr - 1) % J."""
        q = g
        coeffs = []
        for k in range(J):  # newest -> oldest
            idx = (ptr - 1 - k) % J
            ok = k < count
            a = torch.where(ok, rho[rows, idx] * _dot(S[rows, idx], q), 0.0)
            q = q - a[:, None] * Y[rows, idx]
            coeffs.append((idx, ok, a))
        q = alpha * q
        for idx, ok, a in reversed(coeffs):
            b = torch.where(ok, rho[rows, idx] * _dot(Y[rows, idx], q), 0.0)
            q = q + torch.where(ok, a - b, 0.0)[:, None] * S[rows, idx]
        return q

    def backtrack(z, f, g, p, frozen):
        """Armijo backtracking, the step halving until sufficient decrease.
        Returns (step, f_new, g_new, accepted); a frozen path does not
        search (its step is discarded)."""
        gp = _dot(g, p)
        step = torch.ones((P,), dtype=dtype, device=dev)
        fb, gb = f, g
        done = torch.zeros((P,), dtype=torch.bool, device=dev)
        active = ~frozen
        for _ in range(max_backtracks):
            if not bool(active.any()):
                break
            f_try, g_try = value_and_grad(z + step[:, None] * p)
            ok = torch.isfinite(f_try) & (f_try <= f + c1 * step * gp)
            upd = active & ok
            fb = torch.where(upd, f_try, fb)
            gb = torch.where(upd[:, None], g_try, gb)
            step = torch.where(active & ~ok, step * 0.5, step)
            done = done | upd
            active = active & ~ok
        return torch.where(done, step, 0.0), fb, gb, done

    def update_alpha(alpha, s, y, ok):
        """Diagonal inverse-Hessian estimate (Zhang et al. 2022, eq. 10);
        rejected pairs and non-positive results keep the old estimate."""
        a = _dot(y * alpha, y)[:, None]
        b = _dot(y, s)[:, None]
        c = _dot(s / alpha, s)[:, None]
        inv = a / (b * alpha) + y * y / b - (a * s * s) / (b * c * alpha**2)
        new = 1.0 / inv
        good = torch.isfinite(new) & (new > 0)
        return torch.where(ok[:, None] & good, new, alpha)

    f, g = value_and_grad(z0)
    z, g0 = z0, g
    S = torch.zeros((P, J, d), dtype=dtype, device=dev)
    Y = torch.zeros((P, J, d), dtype=dtype, device=dev)
    rho = torch.zeros((P, J), dtype=dtype, device=dev)
    ptr = torch.zeros((P,), dtype=torch.long, device=dev)
    count = torch.zeros((P,), dtype=torch.long, device=dev)
    alpha = torch.ones((P, d), dtype=dtype, device=dev)
    frozen = torch.zeros((P,), dtype=torch.bool, device=dev)
    zs, gs, alphas, ss, ys, oks, moves = [], [], [], [], [], [], []
    for _ in range(maxiter):
        if bool(frozen.all()):
            break  # the remaining steps are recorded below, as the scan records them
        p = -two_loop(g, S, Y, rho, ptr, count, alpha)
        # steepest descent where the direction is not a descent direction (stale curvature)
        descent = _dot(g, p) < 0
        p = torch.where(descent[:, None], p, -alpha * g)
        step_len, f_new, g_new, accepted = backtrack(z, f, g, p, frozen)
        moved = accepted & ~frozen
        z_new = torch.where(moved[:, None], z + step_len[:, None] * p, z)
        f_new = torch.where(moved, f_new, f)
        g_new = torch.where(moved[:, None], g_new, g)
        s = z_new - z
        y = g_new - g
        sy = _dot(s, y)
        pair_ok = moved & (sy > eps_curv * _norm(s) * _norm(y))
        alpha_new = update_alpha(alpha, s, y, pair_ok)
        slot = ptr % J
        upd = pair_ok[:, None] & (torch.arange(J, device=dev)[None, :] == slot[:, None])  # [P, J]
        S = torch.where(upd[..., None], s[:, None, :], S)
        Y = torch.where(upd[..., None], y[:, None, :], Y)
        rho = torch.where(upd, (1.0 / torch.where(sy > 0, sy, 1.0))[:, None], rho)
        ptr = torch.where(pair_ok, ptr + 1, ptr)
        count = torch.where(pair_ok, torch.clamp(count + 1, max=J), count)
        frozen = frozen | ~accepted | (_norm(g_new) < tol)
        z, f, g, alpha = z_new, f_new, g_new, alpha_new
        zs.append(z)
        gs.append(g)
        alphas.append(alpha)
        ss.append(s)
        ys.append(y)
        oks.append(pair_ok)
        moves.append(moved)
    pad = maxiter - len(zs)
    zero = torch.zeros_like(z)
    no = torch.zeros((P,), dtype=torch.bool, device=dev)
    zs += [z] * pad
    gs += [g] * pad
    alphas += [alpha] * pad
    ss += [zero] * pad
    ys += [zero] * pad
    oks += [no] * pad
    moves += [no] * pad
    return Trajectory(
        iterates=torch.stack([z0] + zs, dim=1),
        grads=torch.stack([g0] + gs, dim=1),
        alphas=torch.stack([torch.ones_like(z0)] + alphas, dim=1),
        pair_s=torch.stack(ss, dim=1),
        pair_y=torch.stack(ys, dim=1),
        pair_ok=torch.stack(oks, dim=1),
        valid=torch.stack([torch.ones((P,), dtype=torch.bool, device=dev)] + moves, dim=1),
    )


# ---------------------------------------------------------------------------
# Low-rank-plus-diagonal Gaussian from the compact BFGS representation
# ---------------------------------------------------------------------------


def factor(alpha, S_win, Y_win, ok_win):
    """Sigma = diag(alpha) + B Gamma B^T from windows of (s, y) pairs
    (Byrd, Nocedal & Schnabel 1994), reduced by a thin QR to sampling and
    log-density primitives; batched over leading axes (``alpha`` [..., d],
    ``S_win``/``Y_win`` [..., J, d], ``ok_win`` [..., J]).

    Returns (sqrt_alpha [..., d], Q [..., d, m], Lm [..., m, m] lower,
    half_logdet [...]), m = min(d, 2J): draws are
    ``mu + sqrt_alpha * (eps + Q @ ((Lm - I) @ (Q^T eps)))`` and the
    log-density quadratic form of a self-drawn eps is ``|eps|^2``.  Masked
    pairs contribute nothing.  Q, its R factor and Lm are fixed only up to
    column signs; the draws and ``half_logdet`` are not."""
    J = S_win.shape[-2]
    dtype, dev = alpha.dtype, alpha.device
    okf = ok_win.to(dtype)
    S = S_win * okf[..., None]
    Y = Y_win * okf[..., None]
    sty = S @ Y.mT  # [..., J, J]
    eye_J = torch.eye(J, dtype=dtype, device=dev)
    # R = upper triangle of S^T Y with each masked diagonal entry 1 (so R
    # stays invertible; the zeroed B columns kill those coordinates anyway)
    R = torch.triu(sty) + torch.diag_embed(torch.where(ok_win, 0.0, 1.0).to(dtype))
    D = torch.diag_embed(torch.where(ok_win, torch.diagonal(sty, dim1=-2, dim2=-1), 1.0))
    AY = alpha[..., :, None] * Y.mT  # [..., d, J]
    B = torch.cat([S.mT, AY], dim=-1)  # [..., d, 2J]
    Rinv = torch.linalg.solve_triangular(R, eye_J.expand_as(R), upper=True)
    mid = D + Y @ (alpha[..., :, None] * Y.mT)
    E = Rinv.mT @ mid @ Rinv
    zero = torch.zeros_like(E)
    gamma = torch.cat([torch.cat([E, -Rinv.mT], dim=-1), torch.cat([-Rinv, zero], dim=-1)], dim=-2)
    sqrt_alpha = torch.sqrt(alpha)
    # reduced QR: Q [d, m], Rq [m, 2J], m = min(d, 2J), so the construction
    # holds when d < 2J (low-dimensional problems)
    Q, Rq = torch.linalg.qr(B / sqrt_alpha[..., :, None], mode="reduced")
    m = Rq.shape[-2]
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    small = eye_m + Rq @ gamma @ Rq.mT
    # masked-out or degenerate directions give an identity block; a tiny
    # jitter keeps the factor finite in float32
    small = small + 1e-10 * eye_m
    Lm = torch.linalg.cholesky(small)
    half_logdet = torch.sum(torch.log(sqrt_alpha), dim=-1) + torch.sum(
        torch.log(torch.diagonal(Lm, dim1=-2, dim2=-1)), dim=-1)
    return sqrt_alpha, Q, Lm, half_logdet


def draw(mu, sqrt_alpha, Q, Lm, eps):
    """Draws from N(mu, Sigma) given the factor: ``eps`` [..., K, d]
    standard normals, the factor's tensors with the same leading axes."""
    t = eps @ Q  # [..., K, m] = (Q^T eps) per draw
    return mu[..., None, :] + sqrt_alpha[..., None, :] * (eps + (t @ Lm.mT - t) @ Q.mT)


# ---------------------------------------------------------------------------
# The multi-path fit
# ---------------------------------------------------------------------------


def _windows(traj: Trajectory, J: int):
    """The pair windows of iterates 1..L: pairs (l - J .. l - 1), clamped
    and masked; [P, L, J, d] and [P, L, J]."""
    P, L = traj.pair_ok.shape
    dev = traj.pair_ok.device
    idx = torch.arange(1, L + 1, device=dev)[:, None] - J + torch.arange(J, device=dev)[None, :]  # [L, J]
    clipped = torch.clamp(idx, 0, L - 1)
    ok = (idx >= 0)[None] & traj.pair_ok[:, clipped]
    return traj.pair_s[:, clipped], traj.pair_y[:, clipped], ok


def pathfinder_fit(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_paths: int = 8,
    maxiter: int = 60,
    history: int = 6,
    num_elbo_draws: int = 30,
    num_draws_per_path: int = 256,
    initial_points=None,
    psis_smooth: bool = True,
    draws: Optional[PathfinderDraws] = None,
) -> PathfinderResult:
    """Fit a posterior by multi-path Pathfinder (Zhang et al. 2022).

    Each of ``num_paths`` L-BFGS ascents contributes the Gaussian (from its
    compact inverse-Hessian estimate, window ``history``) whose ELBO is
    largest along the trajectory; ``num_draws_per_path`` draws per path
    pool with exact importance weights, Pareto-smoothed when
    ``psis_smooth``.  Returns the weighted draws, per-path ELBO lower bounds
    on log evidence, an importance-sampling log-evidence estimate and the
    pooled Pareto k-hat (trust the weights when k < 0.7).

    ``initial_points`` ([num_paths, d], constrained space) seeds the paths;
    default is uniform over the z-space box [-2, 2]^d.  The fit runs on the
    problem's device; ``generator`` None is one there seeded 0, and
    ``draws`` (:func:`pathfinder_draws`) replaces its numbers."""
    dev, dtype, d = problem.device, problem.dtype, problem.dim
    P, K, M, J = num_paths, num_elbo_draws, num_draws_per_path, history
    if draws is None:
        generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
        draws = pathfinder_draws(generator, P, d, K, M, dtype)
    if (tuple(draws.init.shape) != (P, d) or tuple(draws.elbo.shape) != (P, K, d)
            or tuple(draws.final.shape) != (P, M, d)):
        raise ValueError(f"draws must be [{P}, {d}], [{P}, {K}, {d}] and [{P}, {M}, {d}]")
    bij = box_bijection(problem.lower, problem.upper)
    if initial_points is not None:
        pts = torch.as_tensor(initial_points, dtype=dtype, device=dev)
        if tuple(pts.shape) != (P, d):
            raise ValueError(f"initial_points must be [{P}, {d}], got {tuple(pts.shape)}")
        z0 = bij.to_z(pts)
    else:
        z0 = draws.init.to(dtype)
    log_target = z_log_target(problem, bij)
    tol = 1e-9 if dtype == torch.float64 else 1e-5

    def neg_vg(z):
        v, g = _value_and_grad(lambda u: -log_target(u), z)
        return v, _safe_grad(g)

    traj = lbfgs_trajectories(neg_vg, z0, maxiter=maxiter, history=J, tol=tol)
    L = maxiter  # iterates 1..L compete (iterate 0 has no pairs)
    with torch.no_grad():
        S_win, Y_win, ok_win = _windows(traj, J)
        sqrt_a, Q, Lm, half_logdet = factor(traj.alphas[:, 1:], S_win, Y_win, ok_win)  # [P, L, ...]
        const = 0.5 * d * math.log(2.0 * math.pi)
        # the ELBO of every valid iterate's Gaussian on the path's shared normals
        valid = traj.valid[:, 1:]
        pi, li = torch.nonzero(valid, as_tuple=True)
        eps = draws.elbo.to(dtype)
        elbos = torch.full((P, L), -math.inf, dtype=dtype, device=dev)
        if pi.numel():
            z = draw(traj.iterates[pi, li + 1], sqrt_a[pi, li], Q[pi, li], Lm[pi, li], eps[pi])  # [V, K, d]
            logq = -const - half_logdet[pi, li][:, None] - 0.5 * torch.sum(eps[pi] * eps[pi], dim=-1)
            lp = in_chunks(log_target, z.reshape(-1, d)).reshape(z.shape[:2])
            elbos[pi, li] = torch.mean(lp - logq, dim=-1)
        elbos = torch.where(torch.isfinite(elbos), elbos, -math.inf)
        best = torch.argmax(elbos, dim=-1)  # the first maximum, as jnp.argmax
        rows = torch.arange(P, device=dev)
        # final draws from each path's winning approximation
        mu = traj.iterates[rows, best + 1]
        eps2 = draws.final.to(dtype)
        zs = draw(mu, sqrt_a[rows, best], Q[rows, best], Lm[rows, best], eps2)  # [P, M, d]
        logq = -const - half_logdet[rows, best][:, None] - 0.5 * torch.sum(eps2 * eps2, dim=-1)
        xs = bij.to_x(zs)
        logp = in_chunks(log_target, zs.reshape(-1, d)).reshape(P, M)
        log_iw = logp - logq
        # the argmax over noisy per-iterate ELBOs overshoots (winner's
        # curse): the winner's ELBO is re-estimated on the final draws
        elbo_p = torch.mean(log_iw, dim=-1)
    xs = xs.reshape(P * M, d)
    log_iw = log_iw.reshape(P * M)
    n = xs.shape[0]
    # evidence from the raw weights; draws outside extra constraints carry
    # about zero weight
    log_z_is = logsumexp(log_iw) - math.log(float(n))
    if psis_smooth:
        from ..results.information import _psis_smooth_tail

        # centred on the max first: the tail fit exponentiates absolute
        # log-ratios, which a large common offset would under- or overflow
        lw = log_iw.detach().cpu().numpy().astype(np.float64)
        shift = float(np.max(lw))
        smoothed, khat = _psis_smooth_tail(lw - shift)
        log_w = torch.as_tensor(smoothed + shift, dtype=dtype, device=dev)
        pareto_k = torch.tensor(khat, dtype=dtype, device=dev)
    else:
        log_w = log_iw
        pareto_k = torch.tensor(math.nan, dtype=dtype, device=dev)
    return PathfinderResult(
        samples=WeightedSamples(points=xs, log_weights=log_w), elbo_per_path=elbo_p, best_iteration=best,
        log_evidence_is=log_z_is, pareto_k=pareto_k, path_loc=mu, lower=problem.lower, upper=problem.upper,
        param_names=problem.param_names,
    )
