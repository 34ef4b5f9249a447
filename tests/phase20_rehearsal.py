"""A CPU rehearsal of ``chip_smoke.py`` phase 20 (the parallel engines, one
batch and split over a 4-shard mesh) at small sizes.  Not collected by
pytest.

``python tests/phase20_rehearsal.py``
    Runs ``chip_smoke.phase_parallel_engines`` on CPU tensors with a GP
    slice of n = 64 (nested sampling of its three hyperparameters, pool 40,
    for 20b GP's and 20c's starting draws), shrunken sub-phases and 20e's
    runs in-process.  The mesh is four CPU shards.

On CPU tensors the ``se_covariance`` and ``cholesky`` ops run their plain
versions and launch no kernel, so the phase's launch gates could not pass.
The rehearsal therefore wraps the op functions that the GP modules call
(``ops.gp_kernels.se_covariance`` and ``ops.gp_kernels.cholesky``) and
adds one per call to the kernels' launch counters and to their counters by
device (index None: the CPU).  Its counts are op calls, not kernel
launches.  ``torch.cuda.synchronize`` is made a no-op, as there is no card
to wait for.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling  # noqa: E402
from bayesianinference_tpu_torch.ops import gp_kernels as gk  # noqa: E402

SIZES = dict(smc=dict(runs=4, particles=50, steps=3),
             hmc=dict(warmup=12, samples=6, moments=dict(chains=16, warmup=30, samples=20, leapfrog=5)),
             ensemble=dict(walkers=16, warmup=10, samples=60, batches=4),
             ibis=dict(particles=256, steps=5), dynamic_ns=dict(runs=4, pool=24, batches=4, steps=10))


def _counting(fn, counter: str):
    """``fn`` adding one to ``gk.<counter>.launches`` and to its CPU count
    by device a call (looked up at the call: the phase's kernel watch swaps
    the counted functions)."""
    def wrapped(*args, **kwargs):
        c = getattr(gk, counter)
        c.launches += 1
        c.launches_by_device[None] += 1
        return fn(*args, **kwargs)

    return wrapped


def main():
    torch.cuda.synchronize = lambda *a, **k: None
    gk.se_covariance = _counting(gk.se_covariance, "se_covariance_cuda")
    gk.cholesky = _counting(gk.cholesky, "cholesky_cuda")
    cs.SLICE_N = 64
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(64, cs.SLICE_D)))
    y = torch.sin(x[:, 0]) + 0.1 * torch.tensor(rng.normal(size=64))
    problem = cs._gp_problem(x, y)
    res = nested_sampling(problem, torch.Generator().manual_seed(0), sample_pool_size=40, num_delete=4,
                          monte_carlo_steps=20)
    t = time.perf_counter()
    total = cs.phase_parallel_engines("CPU rehearsal", problem, (res, None, problem), "cpu", None, **SIZES)
    print(f"op calls counted as launches {total}; {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
