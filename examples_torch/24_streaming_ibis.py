"""Streaming Bayesian updating with IBIS + prequential model comparison.

Observations arrive in batches; after each batch the IBIS particle
population IS the current posterior — no refitting.  The per-batch
evidence increments log p(y_batch | y_past) are genuine one-step-ahead
predictive scores, so their running sums compare models ON DATA NEITHER
HAS SEEN YET — here a Student-t noise model overtakes a Gaussian one as
outliers accumulate.

Run:  python examples_torch/24_streaming_ibis.py
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

from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import ibis_sampler
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- data: a location with t3 noise (occasional outliers) ----
rng = np.random.default_rng(2)
n = 120
data = torch.as_tensor(1.5 + 0.6 * rng.standard_t(df=3, size=n), device=DEVICE)


def make(noise_dist):
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0), ("scale", 0.05, 5.0)],
        log_likelihood=lambda th: torch.sum(
            noise_dist(th).log_prob(data)
        ),
        prior_distribution=d.Product(
            (d.Normal(0.0, 3.0), d.LogNormal(0.0, 1.0))
        ),
        validate=False,
        device=DEVICE,
        dtype=torch.float64,
    )

    def pointwise(th, y):
        return noise_dist(th).log_prob(y)

    return problem, pointwise


models = {
    "Gaussian": make(lambda th: d.Normal(th[0], th[1])),
    "Student-t3": make(lambda th: d.StudentT(3.0, th[0], th[1])),
}

batch = 10
runs = {}
for name, (problem, pointwise) in models.items():
    res = ibis_sampler(
        problem, pointwise, data, torch.Generator(DEVICE).manual_seed(0),
        n_particles=512 if SMOKE else 4096, batch_size=batch,
        mcmc_steps=8 if SMOKE else 25,
    )
    runs[name] = res
    w = np.exp(res.log_weights.cpu().numpy())
    w /= w.sum()
    mu = float((w * res.particles[:, 0].cpu().numpy()).sum())
    print(f"{name:11}: final logZ {float(res.log_evidence):8.2f}, "
          f"posterior mu {mu:.3f}, "
          f"resampled {int(res.resampled.sum())}/"
          f"{res.log_predictives.shape[0]} stages")

diff = np.cumsum(runs["Student-t3"].log_predictives.cpu().numpy()) - np.cumsum(
    runs["Gaussian"].log_predictives.cpu().numpy()
)
print(f"final prequential advantage of Student-t3: {diff[-1]:.2f} nats")

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped ibis_streaming.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    stages = (np.arange(diff.shape[0]) + 1) * batch
    ax1.plot(stages, diff, "o-")
    ax1.axhline(0, c="k", lw=0.8)
    ax1.set_xlabel("observations seen")
    ax1.set_ylabel("cumulative log-score advantage (t3 - Gaussian)")
    ax1.set_title("prequential model comparison, updated per batch")

    for name, res in runs.items():
        ax2.plot(stages, res.ess_history.cpu().numpy(), "o-", label=name)
    ax2.axhline(0.5 * 4096, c="k", ls="--", lw=0.8, label="resample threshold")
    ax2.set_xlabel("observations seen"); ax2.set_ylabel("ESS before resampling")
    ax2.set_title("particle health"); ax2.legend()
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "ibis_streaming.png"), dpi=110)
    print("wrote ibis_streaming.png")
