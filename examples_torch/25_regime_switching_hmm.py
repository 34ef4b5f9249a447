"""Regime-switching returns with an exact hidden-Markov likelihood.

A 2-state Gaussian HMM (calm vs turbulent regime, different means AND
volatilities): `define_hidden_markov_model` gives every engine the
EXACT marginal likelihood (forward algorithm — all 2^T paths summed),
Laplace fits means/vols/transition logits, forward-backward smoothing
recovers the regime probabilities, Viterbi decodes the MAP path, and
FFBS draws joint hidden paths that integrate parameter uncertainty —
answering path questions ("longest turbulent spell") by direct MC.

The hidden regimes are the JAX example's own draw (``hmm_sample_states``
under JAX's PRNGKey(4)), read from ``data/hmm_jax_states.npz``, so both
packages fit the same data.

Run:  python examples_torch/25_regime_switching_hmm.py
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
from bayesianinference_tpu_torch.engines import (
    define_hidden_markov_model,
    laplace_posterior_fit,
    most_likely_states,
    regime_probabilities,
    sample_hidden_paths,
)
from bayesianinference_tpu_torch.ops import HMM, row_stochastic

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate: sticky 2-regime Gaussian returns ----
TRUE = dict(mu=(0.05, -0.1), sigma=(0.4, 1.4), p_stay=(0.97, 0.90))
T = 120 if SMOKE else 600
# the JAX example's hmm_sample_states(PRNGKey(4), gen, T) of the chain with
# initial probabilities (0.5, 0.5) and TRUE's stay probabilities
with np.load(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "data", "hmm_jax_states.npz")) as _z:
    z_true = _z[f"z{T}"]
rng = np.random.default_rng(0)
y = torch.as_tensor(
    np.take(TRUE["mu"], z_true) + np.take(TRUE["sigma"], z_true) * rng.normal(size=T), device=DEVICE
)


def builder(theta):
    mu = torch.stack([theta[0], theta[1]])
    log_sig = torch.stack([theta[2], theta[3]])
    hmm = HMM(
        initial_log_probs=torch.log(torch.full((2,), 0.5, dtype=theta.dtype, device=theta.device)),
        transition_log_probs=row_stochastic(
            torch.stack([theta[4], theta[5]])[:, None]
        ),
    )
    log_obs = (
        -0.5 * ((y[:, None] - mu) * torch.exp(-log_sig)) ** 2
        - log_sig
        - 0.5 * np.log(2 * np.pi)
    )
    return hmm, log_obs


problem = define_hidden_markov_model(
    builder,
    parameters=[
        ("mu_calm", -1.0, 1.0),
        ("mu_turb", -1.0, 1.0),
        # disjoint volatility boxes break the label-switching symmetry:
        # "calm" is DEFINED as the sigma<0.8 regime
        ("log_sig_calm", -3.0, -0.2),
        ("log_sig_turb", 0.0, 2.0),
        ("logit_stay_calm", -2.0, 8.0),
        ("logit_leave_turb", -8.0, 2.0),
    ],
    prior_distribution=["location"] * 6,
    validate=False,
    device=DEVICE,
    dtype=torch.float64,
)

fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
mu0, mu1, ls0, ls1, l0, l1 = fit.mean.cpu().numpy()
print("MAP parameters (true in parens):")
print(f"  mu      calm {mu0:+.3f} ({TRUE['mu'][0]})   turb {mu1:+.3f} ({TRUE['mu'][1]})")
print(f"  sigma   calm {np.exp(ls0):.3f} ({TRUE['sigma'][0]})   turb {np.exp(ls1):.3f} ({TRUE['sigma'][1]})")
print(f"  p_stay  calm {1/(1+np.exp(-l0)):.3f} ({TRUE['p_stay'][0]})   turb {1/(1+np.exp(l1)):.3f} ({TRUE['p_stay'][1]})")
print(f"exact log evidence (Laplace): {float(fit.log_evidence):.1f}")

g = regime_probabilities(problem, fit.mean).cpu().numpy()
vit = most_likely_states(problem, fit.mean).cpu().numpy()
acc = np.mean(vit == z_true)
acc = max(acc, 1 - acc)  # label switching
print(f"Viterbi regime accuracy: {acc:.3f}")

# joint paths with parameter uncertainty: longest turbulent spell
thetas = fit.posterior_distribution.sample(torch.Generator(DEVICE).manual_seed(1), (16,))
paths = sample_hidden_paths(
    problem, torch.Generator(DEVICE).manual_seed(2), thetas, paths_per_theta=64
).cpu().numpy().reshape(-1, T)


def longest_run(row):
    best = cur = 0
    for v in row:
        cur = cur + 1 if v == 1 else 0
        best = max(best, cur)
    return best


runs = np.asarray([longest_run(r) for r in paths])
print(
    f"longest turbulent spell: median {np.median(runs):.0f} steps, "
    f"90% CI [{np.percentile(runs, 5):.0f}, {np.percentile(runs, 95):.0f}]"
)

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped regime_hmm.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(10, 6), sharex=True, height_ratios=[2, 1]
    )
    t = np.arange(T)
    ax0.plot(t, y.cpu().numpy(), lw=0.7, color="k")
    ax0.set_ylabel("return")
    ax0.set_title(
        f"2-regime HMM: exact logZ {float(fit.log_evidence):.1f}, "
        f"Viterbi accuracy {acc:.2f}"
    )
    ax1.fill_between(t, 0, g[:, 1], color="C3", alpha=0.5, label="P(turbulent | y)")
    ax1.step(t, z_true, lw=0.8, color="k", alpha=0.6, label="true regime")
    ax1.set_ylabel("regime")
    ax1.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "regime_hmm.png"), dpi=110)
    print("wrote regime_hmm.png")
