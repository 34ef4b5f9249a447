"""Parallel HMC at the JAX smoke configuration (8 chains, 60 warmup + 40
samples, the 2-D standard normal in [-5, 5]^2), in both packages.  Not
collected by pytest.

``python tests/parallel_hmc_study.py [seeds] [keys]``
    * The spread over seeds: the port's ``parallel_hmc`` on CPU tensors from
      ``Generator().manual_seed(s)`` for s < ``seeds`` (default 16), with
      L = 5 (diagonal and dense mass) and ``"auto"``: the standard
      deviation of log step size, log inverse mass (its diagonal) and log
      trajectory length, and the trajectory's steps (length / step size).
      ``chip_smoke.py`` 20b derives its step-size gate from the first.
    * Replay: for ``PRNGKey(k)``, k < ``keys`` (default 4), the JAX function
      on the 8-device CPU mesh and the port on that run's draws (as
      ``tests/test_torch_parallel_smc_hmc.py`` replays it): the largest
      relative difference of each field, and the steps of the frozen
      trajectory on each side.
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
KINDS = {"diagonal": dict(num_leapfrog=5), "dense": dict(num_leapfrog=5, dense_mass=True),
         "auto": dict(num_leapfrog="auto")}
RUN = dict(num_chains=8, num_warmup=60, num_samples=40)
FIELDS = ("samples", "step_size", "inv_mass_diag", "trajectory_length", "acceptance_rates")


def _mass(m):
    m = np.asarray(m)
    return np.diag(m) if m.ndim == 2 else m


def spread(seeds: int) -> None:
    from test_torch_parallel_smc_hmc import _problems

    from bayesianinference_tpu_torch.parallel import parallel_hmc

    _, tp = _problems()
    for name, kw in KINDS.items():
        runs = [parallel_hmc(tp, torch.Generator().manual_seed(s), **RUN, **kw) for s in range(seeds)]
        eps = np.log([float(r.step_size) for r in runs])
        mass = np.log([_mass(r.inv_mass_diag) for r in runs])
        traj = np.log([float(r.trajectory_length) for r in runs])
        steps = np.exp(traj - eps)
        print(f"{name}, {seeds} seeds: sd of log step size {eps.std(ddof=1):.3f}, of log inverse mass "
              f"{np.round(mass.std(0, ddof=1), 3).tolist()}, of log trajectory length {traj.std(ddof=1):.3f}; "
              f"steps a trajectory {steps.min():.2f}-{steps.max():.2f}", flush=True)


def replay(keys: int) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from test_torch_parallel_smc_hmc import T, _mesh_hmc_draws, _problems

    from bayesianinference_tpu.engines.nested_sampling import generate_starting_points as j_starts
    from bayesianinference_tpu.parallel import make_mesh
    from bayesianinference_tpu.parallel import parallel_hmc as j_parallel_hmc
    from bayesianinference_tpu_torch.parallel import parallel_hmc

    jp, tp = _problems()
    mesh = make_mesh(("chains",))
    for name, kw in KINDS.items():
        for k in range(keys):
            key = jax.random.PRNGKey(k)
            want = j_parallel_hmc(jp, key, mesh=mesh, **RUN, **kw)
            start = np.asarray(j_starts(jp, jax.random.split(key)[0], RUN["num_chains"]))
            draws = _mesh_hmc_draws(key, RUN["num_chains"], mesh.shape["chains"], 2, RUN["num_warmup"],
                                    RUN["num_samples"], 1, name == "auto")
            got = parallel_hmc(tp, None, starting_points=T(start), draws=draws, **RUN, **kw)
            errs = []
            for f in FIELDS:
                a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
                errs.append(f"{f} {np.abs(a - b).max() / max(np.abs(b).max(), 1e-300):.1e}")
            steps = [float(r.trajectory_length) / float(r.step_size) for r in (want, got)]
            print(f"{name}, PRNGKey({k}): the port against JAX on its draws: {', '.join(errs)}; steps a "
                  f"trajectory JAX {steps[0]:.3f}, port {steps[1]:.3f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    spread(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
    replay(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
