"""Posterior visualisations (matplotlib); port of
``bayesianinference_tpu.viz.plots``.

``covarianceMatrixPlot`` (VZ:14-37), ``posteriorMarginalPDFPlot1D``
(VZ:39-76), ``posteriorMarginalPDFDensityPlot2D`` (VZ:78-139), the private
CDF variants (VZ:141-237), ``posteriorBubbleChart`` (VZ:240-290) and
``regressionPlot1D`` (VZ:292-388), a renderer for ``calculationReport``
(BayesianStatistics.wl:1485-1608), and the trace, SMC, SBC and calibration
panels.

Each function takes the port's results, with tensors on any device, reads
what it draws into numpy once, and draws what the JAX function draws; the
densities, reports, diagnostics and scores come from the port's own
``GaussianKDE``, ``results.report``, ``results.diagnostics`` and
``results.scoring``.  matplotlib is imported when a function draws, so
importing this module needs none.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..dists.empirical import GaussianKDE
from ..engines.evidence import NestedSamplingResult
from ..results.report import calculation_report

__all__ = [
    "covariance_matrix_plot",
    "posterior_marginal_pdf_plot_1d",
    "posterior_marginal_pdf_density_plot_2d",
    "posterior_marginal_cdf_plot_1d",
    "posterior_marginal_cdf_density_plot_2d",
    "posterior_bubble_chart",
    "regression_plot_1d",
    "calculation_report_plot",
    "smc_report_plot",
    "sbc_rank_plot",
    "calibration_plot",
    "trace_plot",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _points_log_weights(result: NestedSamplingResult):
    return _np(result.points), _np(result.crude_log_posterior_weights)


def _names(result, dim):
    if result.param_names and len(result.param_names) == dim:
        return list(result.param_names)
    return [f"theta_{i}" for i in range(dim)]


def covariance_matrix_plot(result: NestedSamplingResult):
    """Posterior mean bar chart + covariance matrix heatmap (VZ:14-37)."""
    plt = _plt()
    pts, lw = _points_log_weights(result)
    w = np.exp(lw)
    names = _names(result, pts.shape[1])
    mean = w @ pts
    c = pts - mean
    cov = np.einsum("n,ni,nj->ij", w, c, c)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    err = _np(result.parameter_expected_values.standard_error)
    ax1.bar(names, mean, yerr=np.where(np.isfinite(err), err, 0.0))
    ax1.set_title("Parameter expected values")
    im = ax2.imshow(cov, cmap="RdBu_r", vmin=-np.abs(cov).max(), vmax=np.abs(cov).max())
    ax2.set_xticks(range(len(names)), names, rotation=45)
    ax2.set_yticks(range(len(names)), names)
    ax2.set_title("Posterior covariance")
    fig.colorbar(im, ax=ax2)
    fig.tight_layout()
    return fig


def _marginal_kde(pts: np.ndarray, lw: np.ndarray, indices) -> GaussianKDE:
    keep = lw > -700  # drop zero-weight samples for the KDE
    return GaussianKDE.fit(torch.as_tensor(pts[:, list(np.atleast_1d(indices))][keep]), torch.as_tensor(lw[keep]))


def posterior_marginal_pdf_plot_1d(result: NestedSamplingResult, index: int = 0, num_points: int = 200):
    """Weighted-KDE marginal posterior pdf (VZ:39-76)."""
    plt = _plt()
    pts_all, lw = _points_log_weights(result)
    kde = _marginal_kde(pts_all, lw, [index])
    pts = pts_all[:, index]
    lo, hi = pts.min(), pts.max()
    pad = 0.1 * (hi - lo)
    xs = np.linspace(lo - pad, hi + pad, num_points)
    pdf = np.exp(_np(kde.log_prob(torch.as_tensor(xs[:, None]))))
    fig, ax = plt.subplots()
    ax.plot(xs, pdf)
    ax.fill_between(xs, pdf, alpha=0.3)
    ax.set_xlabel(_names(result, pts_all.shape[1])[index])
    ax.set_ylabel("posterior pdf")
    return fig


def posterior_marginal_cdf_plot_1d(result: NestedSamplingResult, index: int = 0, num_points: int = 200):
    """Marginal posterior CDF (the private VZ:141-186 variant)."""
    plt = _plt()
    pts_all, lw = _points_log_weights(result)
    pts, w = pts_all[:, index], np.exp(lw)
    order = np.argsort(pts)
    xs, cdf = pts[order], np.cumsum(w[order])
    fig, ax = plt.subplots()
    ax.step(xs, cdf, where="post")
    ax.set_xlabel(_names(result, pts_all.shape[1])[index])
    ax.set_ylabel("posterior cdf")
    ax.set_ylim(0, 1.02)
    return fig


def posterior_marginal_pdf_density_plot_2d(result: NestedSamplingResult, indices: Sequence[int] = (0, 1),
                                           num_points: int = 80):
    """2-D weighted-KDE density plot (VZ:78-139)."""
    plt = _plt()
    i, j = indices
    pts, lw = _points_log_weights(result)
    kde = _marginal_kde(pts, lw, [i, j])
    los, his = pts[:, [i, j]].min(0), pts[:, [i, j]].max(0)
    pad = 0.1 * (his - los)
    xs = np.linspace(los[0] - pad[0], his[0] + pad[0], num_points)
    ys = np.linspace(los[1] - pad[1], his[1] + pad[1], num_points)
    xx, yy = np.meshgrid(xs, ys)
    grid = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], -1))
    zz = np.exp(_np(kde.log_prob(grid))).reshape(xx.shape)
    fig, ax = plt.subplots()
    im = ax.pcolormesh(xx, yy, zz, shading="auto", cmap="viridis")
    names = _names(result, pts.shape[1])
    ax.set_xlabel(names[i])
    ax.set_ylabel(names[j])
    fig.colorbar(im, ax=ax, label="posterior pdf")
    return fig


def posterior_marginal_cdf_density_plot_2d(result: NestedSamplingResult, indices: Sequence[int] = (0, 1),
                                           num_points: int = 60):
    """2-D empirical joint CDF heatmap (VZ:188-237)."""
    plt = _plt()
    i, j = indices
    pts, lw = _points_log_weights(result)
    w = np.exp(lw)
    xs = np.linspace(pts[:, i].min(), pts[:, i].max(), num_points)
    ys = np.linspace(pts[:, j].min(), pts[:, j].max(), num_points)
    zz = np.zeros((num_points, num_points))
    for a, xv in enumerate(xs):
        le_x = pts[:, i] <= xv
        for b, yv in enumerate(ys):
            zz[b, a] = np.sum(w[le_x & (pts[:, j] <= yv)])
    fig, ax = plt.subplots()
    im = ax.pcolormesh(xs, ys, zz, shading="auto", cmap="viridis", vmin=0, vmax=1)
    names = _names(result, pts.shape[1])
    ax.set_xlabel(names[i])
    ax.set_ylabel(names[j])
    fig.colorbar(im, ax=ax, label="posterior cdf")
    return fig


def posterior_bubble_chart(result: NestedSamplingResult, indices: Sequence[int] = (0, 1), max_bubble: float = 200.0):
    """Sample scatter with bubble size = posterior weight (VZ:240-290);
    three indices give a 3-D scatter."""
    plt = _plt()
    pts, lw = _points_log_weights(result)
    w = np.exp(lw)
    names = _names(result, pts.shape[1])
    sizes = max_bubble * w / w.max()
    if len(indices) == 3:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        i, j, k = indices
        ax.scatter(pts[:, i], pts[:, j], pts[:, k], s=sizes, alpha=0.5)
        ax.set_xlabel(names[i])
        ax.set_ylabel(names[j])
        ax.set_zlabel(names[k])
        return fig
    i, j = indices
    fig, ax = plt.subplots()
    ax.scatter(pts[:, i], pts[:, j], s=sizes, alpha=0.5)
    ax.set_xlabel(names[i])
    ax.set_ylabel(names[j])
    return fig


def regression_plot_1d(
    result,  # NestedSamplingResult | LaplaceFit | None
    predictive,  # PointwiseMixture over x_query
    x_query,
    *,
    x_data=None,
    y_data=None,
    percentiles: Sequence[float] = (0.95, 0.5, 0.05),
    moments: bool = False,
    title: str = None,
):
    """Predictive percentile bands + data overlay + logZ title
    (``regressionPlot1D``, VZ:292-388).  With ``moments=True`` plots
    mean +- stdv instead of percentile curves (the "Moments" spec).
    ``result`` supplies the logZ title: a MeanAndError-carrying engine
    result, anything with a scalar ``log_evidence`` (e.g. a LaplaceFit), or
    ``None`` (pass ``title=`` instead)."""
    plt = _plt()
    xq = _np(x_query).reshape(-1)
    fig, ax = plt.subplots()
    if moments:
        m = _np(predictive.mean())
        s = np.sqrt(_np(predictive.variance()))
        ax.plot(xq, m, label="mean")
        ax.fill_between(xq, m - s, m + s, alpha=0.3, label="±1σ")
    else:
        qs = _np(predictive.quantile(torch.as_tensor(sorted(percentiles), dtype=torch.float64)))
        for p, q in zip(sorted(percentiles), qs):
            ax.plot(xq, q, label=f"{100 * p:g}%")
        if len(qs) >= 2:
            ax.fill_between(xq, qs[0], qs[-1], alpha=0.2)
    if x_data is not None and y_data is not None:
        ax.scatter(_np(x_data).reshape(-1), _np(y_data).reshape(-1), color="k", s=12, zorder=5, label="data")
    if title is not None:
        ax.set_title(title)
    else:
        lz = getattr(result, "log_evidence", None)
        if hasattr(lz, "mean") and hasattr(lz, "standard_error"):
            ax.set_title(f"log evidence: {float(lz.mean):.2f} ± {float(lz.standard_error):.2f}")
        elif lz is not None:
            ax.set_title(f"log evidence: {float(lz):.2f}")
    ax.legend()
    return fig


def calculation_report_plot(result: NestedSamplingResult):
    """All five diagnostic panels of ``calculationReport`` as one figure
    (BS:1485-1608)."""
    plt = _plt()
    rep = calculation_report(result)
    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    ax = axes[0, 0]
    ax.plot(rep.skilling_log_x, rep.skilling_log_likelihood, ".", ms=2)
    ax.set_title("Skilling's plot")
    ax.set_xlabel("Log[X]; enclosed prior mass")
    ax.set_ylabel("LogLikelihood")

    ax = axes[0, 1]
    good = (rep.concentration_x > 0) & (rep.concentration_enclosed_mass > 0)
    ax.loglog(rep.concentration_x[good], rep.concentration_enclosed_mass[good], ".", ms=2)
    if rep.concentration_fit_coefficients is not None:
        b, a = rep.concentration_fit_coefficients
        xs = rep.concentration_x[good]
        ax.loglog(xs, np.exp(b) * xs**a, "r-", lw=1, label=f"{np.exp(b):.3g} x^{a:.2f}")
        ax.legend()
    ax.set_title("Posterior concentration")
    ax.set_xlabel("X; enclosed prior mass")
    ax.set_ylabel("Enclosed posterior mass")

    ax = axes[0, 2]
    ax.plot(rep.evidence_progression)
    ax.set_title("LogEvidence progression")
    ax.set_xlabel("Iteration")

    ax = axes[1, 0]
    ax.plot(rep.log_likelihood_progression, ".", ms=2)
    ax.set_title("LogLikelihood progression")
    ax.set_xlabel("Iteration")

    ax = axes[1, 1]
    if rep.acceptance_rates is not None:
        ax.plot(rep.acceptance_rates, ".", ms=2)
        ax.axhline(0.5, color="r", lw=1)
        ax.set_ylim(0, 1)
    ax.set_title("Acceptance rate")
    axes[1, 2].axis("off")
    fig.tight_layout()
    return fig


def trace_plot(chains, param_names: Sequence[str] = (), max_lag: int = 50):
    """Per-parameter trace + autocorrelation panels for an MCMC chain stack
    [n_chains, n_samples(, d)], the visual companion of
    ``results.effective_sample_size`` / ``gelman_rubin``.

    Left column: overlaid chain traces.  Right column: the chain-mean
    autocorrelation out to ``max_lag`` with the per-parameter ESS and split
    R-hat in the title.  Returns the matplotlib figure.
    """
    from ..results.diagnostics import autocorrelation, effective_sample_size, gelman_rubin

    x = np.asarray(_np(chains), float)
    if x.ndim == 2:
        x = x[:, :, None]
    m, n, d = x.shape
    names = list(param_names) if param_names and len(param_names) == d else [f"theta_{i}" for i in range(d)]
    ess = np.atleast_1d(effective_sample_size(x))
    rhat = np.atleast_1d(gelman_rubin(x))

    plt = _plt()
    fig, axes = plt.subplots(d, 2, figsize=(10, 2.2 * d), squeeze=False, gridspec_kw={"width_ratios": [2.2, 1.0]})
    for i in range(d):
        ax_t, ax_a = axes[i]
        for c in range(m):
            ax_t.plot(x[c, :, i], lw=0.6, alpha=0.8)
        ax_t.set_ylabel(names[i])
        rho = np.mean([autocorrelation(x[c, :, i], max_lag=max_lag) for c in range(m)], axis=0)
        ax_a.bar(np.arange(len(rho)), rho, width=1.0)
        ax_a.axhline(0.0, color="k", lw=0.5)
        ax_a.set_title(f"ESS {ess[i]:.0f}   R-hat {rhat[i]:.3f}", fontsize=9)
        if i == d - 1:
            ax_t.set_xlabel("iteration")
            ax_a.set_xlabel("lag")
    fig.tight_layout()
    return fig


def sbc_rank_plot(result, num_bins: int = 0, columns: int = 3):
    """The SBC rank-histogram panel (Talts et al. 2018, fig. 1) for a
    :class:`..results.sbc.SBCResult`: one histogram per parameter with the
    99% uniform band shaded and the chi-squared uniformity p-value in each
    title.  Bars escaping the band flag miscalibration: U-shapes mean
    under-dispersed posteriors, humps over-dispersed, slopes biased."""
    plt = _plt()
    pvals = _np(result.uniformity_pvalues(num_bins=num_bins))
    d = result.ranks.shape[1]
    rows = -(-d // columns)
    fig, axes = plt.subplots(rows, columns, figsize=(3.4 * columns, 2.6 * rows), squeeze=False)
    n = result.num_replications
    for i in range(d):
        ax = axes[i // columns][i % columns]
        edges, counts = result.histogram(i, num_bins=num_bins)
        b = len(counts)
        # 99% band for Binomial(n, 1/b) counts (normal approximation)
        mean = n / b
        half = 2.576 * np.sqrt(n * (1.0 / b) * (1.0 - 1.0 / b))
        ax.axhspan(mean - half, mean + half, color="0.85", zorder=0)
        ax.axhline(mean, color="0.6", lw=0.8, zorder=1)
        ax.bar(0.5 * (edges[:-1] + edges[1:]), counts, width=edges[1] - edges[0], zorder=2, alpha=0.85)
        ax.set_title(f"{result.param_names[i]}   p = {pvals[i]:.3f}", fontsize=9)
        ax.set_xlabel("rank of true value")
    for j in range(d, rows * columns):
        axes[j // columns][j % columns].set_visible(False)
    fig.tight_layout()
    return fig


def smc_report_plot(result):
    """Three-panel diagnostics of an :class:`..engines.smc.SMCResult`, the
    SMC analogue of :func:`calculation_report_plot`: per-run temperature
    ladders beta_s, realized ESS fractions, and rejuvenation acceptance per
    stage.  NaN-padded history slots (after each run's termination) are not
    drawn."""
    plt = _plt()
    betas, ess, acc = _np(result.betas), _np(result.ess_fractions), _np(result.acceptance_rates)
    n_stages = _np(result.n_stages)
    num_runs = betas.shape[0]

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.4))
    panels = (
        (axes[0], betas, "temperature beta", "log"),
        (axes[1], ess, "ESS fraction", "linear"),
        (axes[2], acc, "MH acceptance", "linear"),
    )
    for ax, hist, label, yscale in panels:
        for r in range(num_runs):
            s = int(n_stages[r])
            ax.plot(np.arange(1, s + 1), hist[r, :s], marker="o", ms=3, alpha=0.8,
                    label=f"run {r}" if num_runs <= 8 else None)
        ax.set_xlabel("stage")
        ax.set_ylabel(label)
        if yscale == "log":
            ax.set_yscale("log")
    z = result.log_evidence
    se = float(z.standard_error)
    fig.suptitle(f"SMC: logZ = {float(z.mean):.3f} " + (f"± {se:.3f}" if np.isfinite(se) else "(single run)"),
                 fontsize=10)
    if num_runs <= 8:
        axes[0].legend(fontsize=7)
    fig.tight_layout()
    return fig


def calibration_plot(predictive, y, num_bins: int = 20):
    """Forecast-calibration dashboard (companion to :mod:`..results.scoring`):
    PIT histogram with the uniform band, empirical-coverage reliability
    curve, and the sharpness (interval width) profile.  ``predictive`` is
    any scalar predictive law with ``cdf``/``quantile`` over m points (e.g. a
    :class:`~..dists.pointwise.PointwiseMixture`); ``y`` the m outcomes."""
    from ..results.scoring import interval_coverage, pit

    plt = _plt()
    y = _np(y)  # numpy goes to the predictive's device and dtype
    u = _np(pit(predictive, y))
    m = u.shape[0]
    levels = np.linspace(0.1, 0.9, 9)
    cov = interval_coverage(predictive, y, levels=tuple(levels))
    emp = np.asarray([float(cov[float(l)][0]) for l in levels])
    width = np.asarray([float(cov[float(l)][1]) for l in levels])

    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(12, 3.6))
    ax1.hist(u, bins=num_bins, range=(0, 1), density=True, alpha=0.8, edgecolor="white")
    ax1.axhline(1.0, color="k", ls="--", lw=1)
    # ~95% sampling band for a uniform histogram
    se = np.sqrt((1 - 1 / num_bins) / (m / num_bins))
    ax1.axhspan(1 - 1.96 * se, 1 + 1.96 * se, color="gray", alpha=0.2)
    ax1.set_title("PIT histogram")
    ax1.set_xlabel("F(y)")

    ax2.plot([0, 1], [0, 1], "k--", lw=1)
    ax2.plot(levels, emp, "o-")
    ax2.set_xlabel("nominal central coverage")
    ax2.set_ylabel("empirical")
    ax2.set_title("reliability")

    ax3.plot(levels, width, "o-")
    ax3.set_xlabel("nominal central coverage")
    ax3.set_ylabel("mean interval width")
    ax3.set_title("sharpness")
    fig.tight_layout()
    return fig
