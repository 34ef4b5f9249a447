"""Parallel nested sampling over a mesh of eight shards (merged exactly),
and a checkpointed single run that can be resumed at any segment.

The JAX example takes its eight devices from a virtual CPU mesh; here the
eight shards are the cards that are present, repeated (every shard on the
one card of a one-card host), or eight CPU shards under
BI_EXAMPLE_DEVICE=cpu.

Run:  python examples_torch/06_parallel_checkpoint.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import tempfile

import numpy as np
import torch

from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import load_ns_run
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.parallel import make_mesh, parallel_nested_sampling

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)


def shard_devices(count=8):
    """``count`` shards over the cards that are present, repeated; the
    host's device ``count`` times off the card."""
    if DEVICE.type != "cuda":
        return [DEVICE] * count
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(count)]


problem = define_inference_problem(
    parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
    log_likelihood=lambda th: torch.sum(d.Normal(0.0, 1.0).log_prob(th)),
    prior_distribution=["location", "location"],
    device=DEVICE,
    dtype=torch.float64,
)

devices = shard_devices()
n_dev = len(devices)
mesh = make_mesh(("runs",), devices=devices)
print(f"mesh: {n_dev} shards on the 'runs' axis over {len(set(devices))} device(s)")
result = parallel_nested_sampling(
    problem,
    torch.Generator(DEVICE).manual_seed(0),
    num_runs=n_dev,
    sample_pool_size=50,  # per run -> total pool n_dev * 50
    mesh=mesh,
    monte_carlo_steps=60,
    max_iterations=1000,
)
print(f"combined logZ = {result.log_evidence} "
      f"(pool {result.sample_pool_size}, {result.total_samples} samples)")

# checkpointed single run: segments of 100 iterations, resumable anytime
_tmp = tempfile.TemporaryDirectory()
checkpoint = _os.path.join(_tmp.name, "ns_checkpoint.npz")
res = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(1), sample_pool_size=60,
    monte_carlo_steps=60, max_iterations=800,
    checkpoint_path=checkpoint, checkpoint_every=100,
)
print(f"checkpointed logZ = {res.log_evidence}")
ck = load_ns_run(checkpoint, device=DEVICE)
print(f"checkpoint holds {int(ck.state.n_dead)} dead points at iteration "
      f"{int(ck.state.iteration) - 1}")
_tmp.cleanup()
