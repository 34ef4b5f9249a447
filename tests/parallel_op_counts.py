"""Dispatched operations per unit of ``chip_smoke.py`` phase 20, on CPU
tensors: the count behind that phase's prediction of CUDA kernels per unit
(``PERF.md``).  Not collected by pytest.

``python tests/parallel_op_counts.py``
    Runs each sub-phase's engine at its phase-20 size (20c at n = 64, where
    the operations do not depend on n) under a ``TorchDispatchMode`` that
    counts the aten operations that are not views (a view launches no
    kernel; most other operations launch one), and prints the count per
    unit: an SMC stage (20a), an HMC trajectory and a leapfrog step (20b), an
    ensemble sweep (20c), an IBIS stage (20d) and a loop iteration of the
    base runs of dynamic NS (20e), each with the units the run took.
"""

import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def counted(fn):
    with Count() as c:
        out = fn()
    return c.n, out


def main():
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.engines import nested_sampling as tns
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops.hmc import _phase_lengths
    from bayesianinference_tpu_torch.parallel import (parallel_dynamic_nested_sampling, parallel_ensemble,
                                                      parallel_hmc, parallel_ibis, parallel_smc)

    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    box, _ = cs._gaussian_box_problem(2, "cpu")
    n, res = counted(lambda: parallel_smc(box, torch.Generator().manual_seed(0), num_runs=8, n_particles=200,
                                          mcmc_steps=8))
    stages = int(res.n_stages.max())
    print(f"20a SMC stage (8 runs x 200 particles, 8 steps): {n / stages:.0f} operations ({stages} stages)")
    for name, kw in (("diagonal", dict(num_leapfrog=5)), ("dense", dict(num_leapfrog=5, dense_mass=True)),
                     ("auto", dict(num_leapfrog="auto"))):
        n, res = counted(lambda: parallel_hmc(box, torch.Generator().manual_seed(0), num_chains=8, num_warmup=60,
                                              num_samples=40, **kw))
        traj = sum(_phase_lengths(60)) + 40
        print(f"20b HMC {name} (8 chains, 60 + 40): {n / traj:.0f} operations a trajectory ({traj} trajectories)")
    n, _ = counted(lambda: parallel_hmc(box, torch.Generator().manual_seed(0), num_chains=64, num_warmup=150,
                                        num_samples=100, num_leapfrog=5))
    traj = sum(_phase_lengths(150)) + 100
    print(f"20b HMC moments (64 chains, 150 + 100, L = 5): {n / traj:.0f} operations a trajectory, "
          f"{n / traj / 5:.0f} a leapfrog step ({traj} trajectories)")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(64, 3))
    x, y = problem_data_from_numpy(x_np, np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=64), device=cpu,
                                   dtype=torch.float64)
    gp = cs._gp_problem(x, y)
    ns = nested_sampling(gp, torch.Generator().manual_seed(0), sample_pool_size=100, num_delete=10,
                         monte_carlo_steps=20, post_process_sampling_runs=0)
    start = ns.points[-32:]
    n1, _ = counted(lambda: parallel_ensemble(gp, torch.Generator().manual_seed(0), num_walkers=32, num_warmup=0,
                                              num_samples=10, starting_points=start))
    n2, _ = counted(lambda: parallel_ensemble(gp, torch.Generator().manual_seed(0), num_walkers=32, num_warmup=0,
                                              num_samples=30, starting_points=start))
    print(f"20c ensemble sweep on the GP (32 walkers, B = 16 a half): {(n2 - n1) / 20:.0f} operations (30 sweeps less "
          f"10)")
    post_mean, post_var, _ = cs._normal_mean_oracle(cs.PAR_DATA)
    problem, yd = cs._normal_mean_problem(cpu, cs.PAR_DATA)
    pointwise = lambda th, v: dists.Normal(th[0], 1.0).log_prob(v)  # noqa: E731
    n, res = counted(lambda: parallel_ibis(problem, pointwise, yd, torch.Generator().manual_seed(1), n_particles=2048,
                                           batch_size=5, mcmc_steps=15))
    moves = int(res.resampled.sum())
    print(f"20d IBIS (2048 particles, 15 steps): {n / res.resampled.numel():.0f} operations a stage, "
          f"{moves} of {res.resampled.numel()} stages moved")
    before = tns.run_loop_batched.host_reads
    n, res = counted(lambda: parallel_dynamic_nested_sampling(problem, torch.Generator().manual_seed(5), num_runs=8,
                                                              sample_pool_size=48, num_batches=8, monte_carlo_steps=40,
                                                              post_process_sampling_runs=50))
    loops = tns.run_loop_batched.host_reads - before
    print(f"20e dynamic NS (8 runs of pool 48, one stage, 40 steps): {n / loops:.0f} operations a loop iteration of "
          f"R runs ({loops} termination reads; {res.iterations} run iterations in all)")


if __name__ == "__main__":
    main()
