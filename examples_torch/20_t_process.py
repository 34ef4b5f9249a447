"""Student-t process regression: heavy-tailed marginals, inferred nu.

The TP (Shah et al. 2014) is the GP's heavy-tailed twin: same kernels,
same engines, but the marginal is a multivariate Student-t whose
predictive width scales with the global surprise (nu + beta)/(nu + n).

A TP is a GP with ONE global inverse-chi-square scale mixture per
draw — so from a single curve with a free amplitude, nu is not
identifiable (the amplitude absorbs the scale draw).  This example
therefore uses REPLICATED series: R independent TP draws sharing
hyperparameters, each with its own scale surprise.  The joint marginal
(a sum of per-series TP logMLs) identifies nu, the TP evidence beats
the GP's decisively, and the per-series predictive bands adapt to each
series' surprise while the GP's width is data-independent.

Run:  python examples_torch/20_t_process.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import laplace_posterior_fit
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.ops.gp_kernels import (
    covariance_matrix,
    gp_log_marginal_likelihood,
    gp_posterior_moments,
    se_kernel,
)
from bayesianinference_tpu_torch.ops.t_process import (
    tp_log_marginal_likelihood,
    tp_posterior_moments,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate R independent TP draws (nu = 3, shared kernel) ----
rng = np.random.default_rng(8)
R, n = 12, 40
nu_true = 3.0
x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
k_true = se_kernel(1.0, 1.0).matrix(
    torch.as_tensor(x, device=DEVICE), torch.as_tensor(x, device=DEVICE)
).cpu().numpy().astype(np.float64) + 0.15**2 * np.eye(n)
l_true = np.linalg.cholesky(k_true)
gs = rng.chisquare(nu_true, size=R) / nu_true  # one scale draw per series
ys = np.stack(
    [l_true @ rng.normal(size=n) / np.sqrt(g) for g in gs]
)  # [R, n]
print(f"per-series scale surprises 1/sqrt(g): {np.round(1/np.sqrt(gs), 2)}")

params = [
    ("amplitude", 0.05, 10.0),
    ("lengthscale", 0.1, 5.0),
    ("noise", 0.01, 2.0),
    ("nu", 2.0, 60.0),
]
ys_j = torch.as_tensor(ys, device=DEVICE)
x_j = torch.as_tensor(x, device=DEVICE)


def tp_joint_logml(th):
    k = covariance_matrix(se_kernel(th[0] ** 2, th[1]), x_j, th[2] ** 2)
    return torch.sum(
        torch.func.vmap(lambda y: tp_log_marginal_likelihood(k, y, th[3]))(ys_j)
    )


def gp_joint_logml(th):
    k = covariance_matrix(se_kernel(th[0] ** 2, th[1]), x_j, th[2] ** 2)
    return torch.sum(torch.func.vmap(lambda y: gp_log_marginal_likelihood(k, y))(ys_j))


tp_problem = define_inference_problem(
    parameters=params, log_likelihood=tp_joint_logml,
    prior_distribution=["location"] * 4, validate=False,
    device=DEVICE, dtype=torch.float64,
)
gp_problem = define_inference_problem(
    parameters=params[:3], log_likelihood=gp_joint_logml,
    prior_distribution=["location"] * 3, validate=False,
    device=DEVICE, dtype=torch.float64,
)

tp_fit = laplace_posterior_fit(problem=tp_problem, generator=torch.Generator(DEVICE).manual_seed(0))
gp_fit = laplace_posterior_fit(problem=gp_problem, generator=torch.Generator(DEVICE).manual_seed(0))
print(f"TP:  theta = {tp_fit.mean.cpu().numpy().round(3)}  "
      f"logZ = {float(tp_fit.log_evidence):.2f}")
print(f"GP:  theta = {gp_fit.mean.cpu().numpy().round(3)}  "
      f"logZ = {float(gp_fit.log_evidence):.2f}")
print(f"evidence prefers "
      f"{'TP' if float(tp_fit.log_evidence) > float(gp_fit.log_evidence) else 'GP'}"
      f" by {abs(float(tp_fit.log_evidence) - float(gp_fit.log_evidence)):.1f}"
      f" nats; inferred nu = {float(tp_fit.mean[3]):.2f} (true {nu_true})")

# ---- per-series predictive bands: TP width adapts, GP width cannot ----
xq = np.linspace(-3.3, 3.3, 121)[:, None]
kern_tp = se_kernel(float(tp_fit.mean[0]) ** 2, float(tp_fit.mean[1]))
kern_gp = se_kernel(float(gp_fit.mean[0]) ** 2, float(gp_fit.mean[1]))
calm, wild = int(np.argmin(1 / np.sqrt(gs))), int(np.argmax(1 / np.sqrt(gs)))
bands = {}
for r in (calm, wild):
    m_tp, s_tp, df = tp_posterior_moments(
        kern_tp, x_j, ys_j[r], torch.as_tensor(xq, device=DEVICE), float(tp_fit.mean[3]),
        nugget=float(tp_fit.mean[2]) ** 2,
    )
    m_gp, s_gp = gp_posterior_moments(
        kern_gp, x_j, ys_j[r], torch.as_tensor(xq, device=DEVICE),
        nugget=float(gp_fit.mean[2]) ** 2,
    )
    bands[r] = tuple(t.cpu().numpy() for t in (m_tp, s_tp)) + (float(df),) + tuple(
        t.cpu().numpy() for t in (m_gp, s_gp))

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped t_process.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=False)
    for ax, r, tag in [(axes[0], calm, "calmest"), (axes[1], wild, "wildest")]:
        m_tp, s_tp, df, m_gp, s_gp = bands[r]
        tcrit = 1.645 * np.sqrt(df / (df - 2))
        ax.fill_between(xq[:, 0], m_tp - tcrit * s_tp, m_tp + tcrit * s_tp,
                        alpha=0.3, label="TP 90% band")
        ax.fill_between(xq[:, 0], m_gp - 1.645 * s_gp, m_gp + 1.645 * s_gp,
                        alpha=0.3, label="GP 90% band")
        ax.plot(xq[:, 0], m_tp, lw=1.2)
        ax.scatter(x[:, 0], ys[r], s=10, c="gray", alpha=0.8)
        ax.set_title(f"{tag} series (1/sqrt(g) = {1/np.sqrt(gs[r]):.2f})")
        ax.set_xlabel("x")
        ax.legend(fontsize=8)
    fig.suptitle("TP predictive width adapts to each series' surprise")
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "t_process.png"), dpi=110)
    print("wrote t_process.png")
