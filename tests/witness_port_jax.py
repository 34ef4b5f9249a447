"""Two studies of the port against the JAX package on the CPU, in float64,
too slow for the suite.  Not collected by pytest.

``python tests/witness_port_jax.py smc-seeds FIRST LAST``
    ``smc_sampler`` of both packages at tests/test_smc.py's setting (the
    2-D Gaussian in a box, 400 particles, 4 runs, 10 MH steps, ESS target
    0.5) for seeds FIRST..LAST-1: each seed's logZ, its standard error and
    its distance from the analytic value in those errors, then every run
    pooled (mean +- the standard error over all runs).

``python tests/witness_port_jax.py gp-hmc SEED WARMUP SAMPLES``
    ``hmc_sample`` of both packages on ``chip_smoke.py`` phase 4's GP
    problem (n = 512, d = 3, SE kernel, log-uniform priors), 16 chains and 8
    leapfrog steps, both from the same 16 prior draws (the port's
    ``generate_starting_points`` at SEED): split R-hat per parameter and
    each chain's mean log-hyperparameters.
"""

import math
import sys
from pathlib import Path

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bayesianinference_tpu_torch.results import gelman_rubin  # noqa: E402

torch.set_num_threads(4)


def smc_seeds(first: int, last: int):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_smc as t

    from bayesianinference_tpu.engines import smc as jsmc
    from bayesianinference_tpu_torch.engines import smc as tsmc

    want = t._analytic_log_z()
    runs = {"port": [], "jax": []}
    for s in range(first, last):
        for name, r in (
            ("port", tsmc.smc_sampler(t._t_problem(), torch.Generator().manual_seed(s), n_particles=400,
                                      num_runs=4, mcmc_steps=10, ess_target=0.5)),
            ("jax", jsmc.smc_sampler(t._j_problem(), jax.random.PRNGKey(s), n_particles=400, num_runs=4,
                                     mcmc_steps=10, ess_target=0.5)),
        ):
            m, e = float(r.log_evidence.mean), float(r.log_evidence.standard_error)
            runs[name].append(np.asarray(r.log_z_runs))
            print(f"{name} seed {s}: {m:.5f} +- {e:.5f}, {(m - want) / e:+.2f} errors from {want:.5f}", flush=True)
    for name, per_seed in runs.items():
        z = np.concatenate(per_seed)
        m, e = z.mean(), z.std(ddof=1) / math.sqrt(len(z))
        print(f"{name}: {len(z)} runs pooled {m:.5f} +- {e:.5f}, {(m - want) / e:+.2f} errors from {want:.5f}")


def gp_hmc(seed: int, warmup: int, samples: int):
    from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
    from bayesianinference_tpu.engines.hmc import hmc_sample as j_hmc_sample
    from bayesianinference_tpu.ops import gp_kernels as jgk
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.engines.nested_sampling import generate_starting_points
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    params = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=512)
    xt, yt = problem_data_from_numpy(x, y, device="cpu", dtype=torch.float64)
    problem = define_gaussian_process(xt, yt, kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
                                      nugget_builder=lambda th: th[2] ** 2, parameters=params,
                                      prior_distribution=["scale"] * 3)
    j_problem = j_define_gp(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), params,
                            nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3)
    starts = generate_starting_points(problem, torch.Generator().manual_seed(seed), 16)
    print("starting log-hyperparameters:", np.round(np.log(starts.numpy()), 2).tolist(), flush=True)
    kw = dict(num_chains=16, num_samples=samples, num_warmup=warmup, num_leapfrog=8)
    for name, r in (
        ("port", hmc_sample(problem, torch.Generator().manual_seed(seed), starting_points=starts, **kw)),
        ("jax", j_hmc_sample(j_problem, jax.random.PRNGKey(seed), starting_points=jnp.asarray(starts.numpy()),
                             **kw)),
    ):
        s = np.asarray(r.samples)
        rhat = [float(gelman_rubin(torch.tensor(s[..., i]))) for i in range(3)]
        print(f"{name}: step size {float(r.step_size):.4f}, split R-hat {np.round(rhat, 3).tolist()}")
        print(f"{name}: each chain's mean log-hyperparameters {np.round(np.log(s).mean(axis=1), 2).tolist()}",
              flush=True)


if __name__ == "__main__":
    study, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"smc-seeds": smc_seeds, "gp-hmc": gp_hmc}[study](*args)
