"""Composed runs x live x data nested sampling on a (2, 2, 2) mesh.

One program carries all three parallel axes (the GPU form of
``parallelNestedSampling``, BayesianStatistics.wl:1317-1371, plus the
long-data/long-pool axes the reference lacks):

* 2 independent runs (merged exactly afterwards),
* each run's live-point pool sharded over 2 shards,
* the likelihood's observation axis sharded over 2 shards and completed
  by one sum per density evaluation.

The JAX example uses 8 virtual CPU devices; here the eight shards are the
cards that are present, repeated (all on the one card of a one-card host),
or eight CPU shards under BI_EXAMPLE_DEVICE=cpu.

Run:  python examples_torch/11_multi_axis_mesh.py
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
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.parallel import (
    make_multi_axis_mesh,
    multi_axis_nested_sampling,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)


def shard_devices(count=8):
    """``count`` shards over the cards that are present, repeated; the
    host's device ``count`` times off the card."""
    if DEVICE.type != "cuda":
        return [DEVICE] * count
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(count)]


# ---- data: 128 observations of an unknown (mu, log sigma) Normal ----
rng = np.random.default_rng(0)
data = torch.as_tensor(rng.normal(0.8, 1.5, size=128), device=DEVICE)


def local_log_likelihood(theta, data_shard):
    """Partial log-likelihood over ONE data shard; the engine completes
    the sum over the 'data' mesh axis."""
    return torch.sum(d.Normal(theta[0], torch.exp(theta[1])).log_prob(data_shard))


problem = define_inference_problem(
    parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
    log_likelihood=lambda th: torch.sum(
        d.Normal(th[0], torch.exp(th[1])).log_prob(data)
    ),
    prior_distribution=["location", "location"],
    device=DEVICE,
    dtype=torch.float64,
)

devices = shard_devices()
mesh = make_multi_axis_mesh(runs=2, live=2, data=2, devices=devices)
print(f"mesh: {dict(mesh.shape)} over {len(set(devices))} device(s)")

result = multi_axis_nested_sampling(
    problem,
    torch.Generator(DEVICE).manual_seed(0),
    mesh=mesh,
    sample_pool_size=128,  # per run, sharded over the 'live' axis
    num_delete=8,
    data=data,
    local_log_likelihood=local_log_likelihood,
    max_iterations=1500,
    min_iterations=50,
    monte_carlo_steps=60,
)

print(f"log evidence : {result.log_evidence}")
print(f"evals        : {result.num_likelihood_evals}")
mu, ls = result.parameter_expected_values.mean
print(f"posterior    : mu = {float(mu):.3f} (truth 0.8), "
      f"sigma = {float(torch.exp(ls)):.3f} (truth 1.5)")
