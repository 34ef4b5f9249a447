"""Posterior summary tables (port of ``bayesianinference_tpu.results.summary``).

One entry point, :func:`summary`, covering every posterior form the
engines produce:

* a :class:`~..engines.evidence.NestedSamplingResult` or
  :class:`~..core.containers.WeightedSamples` — weighted quantiles +
  Kish effective sample size;
* an MCMC chain stack [n_chains, n_samples, d] — sample quantiles +
  Geyer ESS and split R-hat;
* a :class:`~..engines.laplace.LaplaceFit` — Gaussian closed forms.

The reference reports parameter expectations inside the inference object
(``"ParameterExpectedValues"``, BS:1183-1290) and leaves tabulation to
the notebook; this is the framework-native table.  Host-side numpy: a
summary runs once per fit, on tensors from any device (copied to the host
in float64) through the port's :mod:`.diagnostics`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .diagnostics import _host, effective_sample_size, gelman_rubin, weighted_effective_sample_size

__all__ = ["ParameterSummary", "SummaryTable", "summary"]


@dataclasses.dataclass(frozen=True)
class ParameterSummary:
    name: str
    mean: float
    std: float
    quantiles: Tuple[float, ...]
    ess: Optional[float] = None  # Geyer (chains) or Kish (weighted)
    r_hat: Optional[float] = None  # chains only


@dataclasses.dataclass(frozen=True)
class SummaryTable:
    rows: Tuple[ParameterSummary, ...]
    quantile_levels: Tuple[float, ...]

    def __str__(self):
        qh = [f"q{100 * q:g}" for q in self.quantile_levels]
        headers = ["param", "mean", "std", *qh, "ess", "r_hat"]
        table = []
        for r in self.rows:
            table.append(
                [
                    r.name,
                    f"{r.mean:.4g}",
                    f"{r.std:.4g}",
                    *(f"{q:.4g}" for q in r.quantiles),
                    "" if r.ess is None else f"{r.ess:.0f}",
                    "" if r.r_hat is None else f"{r.r_hat:.3f}",
                ]
            )
        widths = [
            max(len(h), *(len(row[i]) for row in table)) if table else len(h)
            for i, h in enumerate(headers)
        ]
        lines = [
            "  ".join(h.rjust(w) for h, w in zip(headers, widths)),
        ]
        for row in table:
            lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {r.name: r for r in self.rows}


def _weighted_quantiles(x, w, qs):
    """Quantiles of a weighted sample: invert the weighted empirical CDF
    (the construction behind ``EmpiricalDistribution`` quantiles)."""
    order = np.argsort(x)
    xs, ws = x[order], w[order]
    cdf = np.cumsum(ws)
    cdf = cdf / cdf[-1]
    return tuple(float(xs[np.searchsorted(cdf, q, side="left")]) for q in qs)


def _names(param_names, d):
    if param_names:
        return list(param_names)
    return [f"theta_{i}" for i in range(d)]


def summary(
    obj,
    *,
    param_names: Sequence[str] = (),
    quantiles: Sequence[float] = (0.05, 0.5, 0.95),
) -> SummaryTable:
    """Per-parameter posterior summary (mean, std, quantiles, and the
    convergence diagnostics appropriate to the input's form)."""
    qs = tuple(float(q) for q in quantiles)

    # Laplace fit: Gaussian closed forms
    from ..engines.laplace import LaplaceFit

    if isinstance(obj, LaplaceFit):
        from scipy.stats import norm

        mean = np.atleast_1d(_host(obj.mean))
        cov = np.linalg.inv(_host(obj.precision_matrix))
        std = np.sqrt(np.clip(np.diagonal(cov), 0.0, None))
        names = _names(param_names or obj.param_names, mean.shape[0])
        rows = tuple(
            ParameterSummary(
                name=names[i],
                mean=float(mean[i]),
                std=float(std[i]),
                quantiles=tuple(
                    float(norm(mean[i], std[i]).ppf(q)) for q in qs
                ),
            )
            for i in range(mean.shape[0])
        )
        return SummaryTable(rows=rows, quantile_levels=qs)

    # weighted-sample forms (NS result / WeightedSamples)
    from ..core.containers import WeightedSamples
    from ..engines.evidence import NestedSamplingResult

    if isinstance(obj, NestedSamplingResult):
        names = param_names or obj.param_names
        obj = obj.posterior_samples()
        param_names = names
    if isinstance(obj, WeightedSamples):
        pts = _host(obj.points)
        w = _host(obj.normalized_weights())
        names = _names(param_names, pts.shape[-1])
        mean = w @ pts
        var = w @ (pts - mean) ** 2
        kish = weighted_effective_sample_size(w)
        rows = tuple(
            ParameterSummary(
                name=names[i],
                mean=float(mean[i]),
                std=float(np.sqrt(max(var[i], 0.0))),
                quantiles=_weighted_quantiles(pts[:, i], w, qs),
                ess=kish,
            )
            for i in range(pts.shape[-1])
        )
        return SummaryTable(rows=rows, quantile_levels=qs)

    # chain stack [m, n(, d)]
    x = _host(obj)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.ndim != 3:
        raise TypeError(
            "summary() takes a NestedSamplingResult, WeightedSamples, "
            "LaplaceFit, or a chain stack [n_chains, n_samples(, d)]; got "
            f"{type(obj).__name__} with shape {getattr(obj, 'shape', None)}"
        )
    m, n, d = x.shape
    names = _names(param_names, d)
    ess = np.atleast_1d(effective_sample_size(x))
    rhat = np.atleast_1d(gelman_rubin(x))
    flat = x.reshape(m * n, d)
    rows = tuple(
        ParameterSummary(
            name=names[i],
            mean=float(flat[:, i].mean()),
            std=float(flat[:, i].std(ddof=1)),
            quantiles=tuple(
                float(np.quantile(flat[:, i], q)) for q in qs
            ),
            ess=float(ess[i]),
            r_hat=float(rhat[i]),
        )
        for i in range(d)
    )
    return SummaryTable(rows=rows, quantile_levels=qs)
