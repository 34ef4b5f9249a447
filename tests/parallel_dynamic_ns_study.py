"""Bias of the parallel dynamic NS oracle over seeds, in both packages.  Not
collected by pytest.

``python tests/parallel_dynamic_ns_study.py [seeds] [steps] [package] [batches]``
    ``tests/test_parallel_dynamic_ibis.py``'s dynamic-NS oracle (the
    Normal mean with 40 observations, pool 48, ``num_batches=8`` over 8
    runs, so one stage, 50 post-processing runs) at ``steps`` chain steps a
    replacement (default 40, the JAX test's; ``default`` for the method's
    dimension law) for seeds 0 to ``seeds`` - 1 (default 10; ``a:b`` for
    seeds a to b - 1).  ``package``: ``jax`` runs the JAX function on the
    8-device CPU mesh (``PRNGKey(seed)``), ``port`` the port's with
    ``num_runs=8`` on CPU tensors (``Generator().manual_seed(seed)``),
    ``both`` (the default) the two, ``card`` the port's on a CUDA card
    (``chip_smoke.py``'s 20e run, seven seeds at a time in worker
    processes; no JAX there).  ``batches`` (default 8) other than 8 changes
    ``num_batches`` (0: the eight merged base runs alone).  Prints each
    seed's z = (logZ - quadrature) / se and each package's mean, sd and
    standard error of z.
"""

import math
import multiprocessing
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SIGMA, TAU = 1.0, 2.0
DATA = np.random.default_rng(3).normal(0.8, 1.0, size=40)


def quadrature_log_z() -> float:
    grid = np.linspace(-10, 10, 4001)
    ll = (-0.5 * ((DATA[None, :] - grid[:, None]) / SIGMA) ** 2).sum(1) - DATA.size * math.log(
        SIGMA * math.sqrt(2 * math.pi))
    lp = -0.5 * (grid / TAU) ** 2 - math.log(TAU * math.sqrt(2 * math.pi))
    return float(np.logaddexp.reduce(ll + lp) + math.log(grid[1] - grid[0]))


def port_z(seed, kw, device="cpu") -> float:
    import torch

    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.models import define_inference_problem
    from bayesianinference_tpu_torch.parallel import parallel_dynamic_nested_sampling

    dev = torch.device(device)
    y = torch.as_tensor(DATA, device=dev)
    full = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)  # noqa: E731
    problem = define_inference_problem(parameters=[("mu", -10.0, 10.0)],
                                       log_likelihood=lambda th: td.Normal(th[0], SIGMA).log_prob(y).sum(),
                                       prior_distribution=td.Product((td.Normal(full(0.0), full(TAU)),)),
                                       validate=False, device=dev, dtype=torch.float64)
    r = parallel_dynamic_nested_sampling(problem, torch.Generator(device=dev).manual_seed(seed), num_runs=8, **kw)
    return (float(r.log_evidence.mean) - quadrature_log_z()) / float(r.log_evidence.standard_error)


def _card_job(args):
    sys.path.insert(0, str(ROOT))
    return port_z(*args, device="cuda")


def jax_runner():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_ENABLE_X64"] = "1"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bayesianinference_tpu import dists as jd
    from bayesianinference_tpu.models import define_inference_problem as j_define
    from bayesianinference_tpu.parallel import parallel_dynamic_nested_sampling as j_pdns

    problem = j_define(parameters=[("mu", -10.0, 10.0)],
                       log_likelihood=lambda th: jnp.sum(jd.Normal(th[0], SIGMA).log_prob(jnp.asarray(DATA))),
                       prior_distribution=jd.Product((jd.Normal(0.0, TAU),)), validate=False)

    def run(seed, kw):
        r = j_pdns(problem, jax.random.PRNGKey(seed), **kw)
        return (float(r.log_evidence.mean) - quadrature_log_z()) / float(r.log_evidence.standard_error)

    return run


def main(seeds=range(10), steps="40", package="both", batches="8"):
    sys.path.insert(0, str(ROOT))
    kw = dict(sample_pool_size=48, num_batches=int(batches), monte_carlo_steps=None if steps == "default" else
              int(steps), post_process_sampling_runs=50)
    zs = {}
    if package == "card":
        with multiprocessing.get_context("spawn").Pool(7) as pool:
            zs["card"] = pool.map(_card_job, [(s, kw) for s in seeds], chunksize=1)
        print(f"card: z {np.round(zs['card'], 3).tolist()}", flush=True)
    else:
        runners = {}
        if package in ("both", "jax"):
            runners["jax"] = jax_runner()
        if package in ("both", "port"):
            runners["port"] = port_z
        for seed in seeds:
            t = time.perf_counter()
            for name, run in runners.items():
                zs.setdefault(name, []).append(run(seed, kw))
            print(f"seed {seed}: " + ", ".join(f"{k} z {v[-1]:+.3f}" for k, v in zs.items())
                  + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    for k, v in zs.items():
        print(f"{k}: steps {steps}, batches {batches}, {len(v)} seeds, mean z {np.mean(v):+.3f}, sd "
              f"{np.std(v, ddof=1):.3f}, standard error of the mean {np.std(v, ddof=1) / np.sqrt(len(v)):.3f}",
              flush=True)


if __name__ == "__main__":
    first, _, last = (sys.argv[1] if len(sys.argv) > 1 else "10").rpartition(":")
    main(range(int(first or 0), int(last)), *sys.argv[2:5])
