"""The coupled run-level engines split per shard over the port's mesh
(``parallel/_mesh.py``, ``parallel/sharding.py::ShardAxis``): parallel HMC
and ChEES, the parallel ensemble, parallel IBIS and parallel dynamic NS,
each shard running its block of the batch as its own batch against its
copy of the problem, with the per-step collectives between the shards.
CPU, float64.

* Replays of the JAX functions on ``tests/conftest.py``'s 8-device CPU mesh
  on JAX's draws, on the port's 8-shard CPU mesh, to 1e-10 relative: HMC
  at two chains a shard with the diagonal mass, the dense mass and ChEES;
  the ensemble at one walker a shard of each half (stretch and DE); IBIS
  at eight particles a shard.  ``test_torch_parallel_smc_hmc.py`` and
  ``test_torch_parallel_ensemble_ibis.py`` replay their own configurations
  through the same split path.  Dynamic NS (whose chains' numbers are the
  port's own) is held to the JAX test's oracle and to the JAX engine's
  logZ on the 8-device mesh within their joint error bar, on a mesh of two
  devices ("cpu" and "cpu:0" compare unequal, so the runs go as two device
  groups).
* The split runs on a 4-shard CPU mesh against the port's one-batch runs on
  the same draws.  The split changes only the order of the reductions that
  cross shards: HMC's mean acceptance (the mean of the shards' means) and
  the moments (per-shard Welford moments Chan-merged) differ in the last
  bits, which dual averaging grows over the warmup (1e-13 to 1e-11 at 12
  warmup iterations here), so HMC is held at 1e-10 over 6 + 3; ChEES's
  chain means and sums the same way, 1e-10; IBIS's logsumexp sums the
  shards' sums, 1e-12; the ensemble's gathers reorder nothing (bit for
  bit); dynamic NS's shards on one device run as one batch (bit for bit).
* The GP slice (n = 64, three hyperparameters, float64) through the
  parallel ensemble and parallel HMC on a 4-shard CPU mesh against the JAX
  functions on a 4-device mesh, 1e-9 relative (the two packages' logML
  differ by 1e-13 relative; the tolerance leaves room for the rounding
  that the HMC warmup grows).
* ``problem_on`` carries a GP problem to ``meta``: its model's x and y,
  box and prior move, its likelihood is rebound to the moved model, and
  the guarded log-likelihood returns a ``meta`` tensor of shape [B] (the
  custom ops' fake rules: nothing closes over a CPU tensor); a density
  closing over a CPU tensor raises and names it.
* One copy per distinct device: on a mesh of the home device and three
  shards on one other device ("cpu" and "cpu:0" compare unequal), the
  engines make two problem copies (the home one is the problem itself),
  ``ShardAxis.send`` two tensor copies, and dynamic NS two problem copies
  over its base run and two stages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_parallel_ensemble_ibis import _gauss_problems, _mesh_ensemble_draws, _mesh_ibis_draws
from test_torch_parallel_smc_hmc import _mesh_hmc_draws, _problems

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.engines.nested_sampling import generate_starting_points as j_starts
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
from bayesianinference_tpu.parallel import parallel_dynamic_nested_sampling as j_parallel_dns
from bayesianinference_tpu.parallel import parallel_ensemble as j_parallel_ensemble
from bayesianinference_tpu.parallel import parallel_hmc as j_parallel_hmc
from bayesianinference_tpu.parallel import parallel_ibis as j_parallel_ibis
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.core.shards import ShardAxis
from bayesianinference_tpu_torch.engines import dynamic_ns, nested_sampling
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
from bayesianinference_tpu_torch.engines.ibis import ibis_stage_draws
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.ops.chees import chees_draws
from bayesianinference_tpu_torch.ops.ensemble import ensemble_draws
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel
from bayesianinference_tpu_torch.ops.hmc import _phase_lengths, hmc_draws
from bayesianinference_tpu_torch.parallel import (make_mesh, parallel_dynamic_nested_sampling, parallel_ensemble,
                                                  parallel_hmc, parallel_ibis)
from bayesianinference_tpu_torch.parallel import _mesh
from bayesianinference_tpu_torch.parallel._mesh import problem_on

torch.set_num_threads(1)
F64 = jnp.float64
HMC_FIELDS = ("samples", "acceptance_rates", "step_size", "inv_mass_diag", "trajectory_length")


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _cpu_mesh(axis, shards):
    return make_mesh((axis,), devices=["cpu"] * shards)


def _stacked(rows):
    """Per-sweep ensemble draws as the two halves with a leading sweep axis."""
    return tuple(type(rows[0][h])(*(torch.stack(f) for f in zip(*(r[h] for r in rows)))) for h in range(2))


# --- replays of the JAX mesh runs (8 shards)

HMC_REPLAYS = {"diagonal": dict(num_leapfrog=4), "dense": dict(num_leapfrog=4, dense_mass=True),
               "auto": dict(num_leapfrog="auto")}


@pytest.mark.parametrize("case", sorted(HMC_REPLAYS))
def test_split_hmc_replays_the_jax_mesh_run_at_two_chains_a_shard(case):
    kw = dict(num_samples=3, num_warmup=6, **HMC_REPLAYS[case])
    chains = 16
    jp, tp = _problems()
    key = jax.random.PRNGKey(3)
    mesh = j_make_mesh(("chains",))
    want = j_parallel_hmc(jp, key, num_chains=chains, mesh=mesh, **kw)
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], chains))
    draws = _mesh_hmc_draws(key, chains, 8, 2, kw["num_warmup"], kw["num_samples"], 1, case == "auto")
    got = parallel_hmc(tp, None, num_chains=chains, starting_points=T(start), draws=draws,
                       mesh=_cpu_mesh("chains", 8), **kw)
    for f in HMC_FIELDS:
        close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.divergences.numpy(), np.asarray(want.divergences))


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_split_ensemble_replays_the_jax_mesh_run_at_one_walker_a_shard(move):
    """16 walkers: one of each half a shard, each moving against the
    gathered complementary half (the DE spread over the whole of it)."""
    jp, tp = _gauss_problems()
    key, walkers, warmup, samples = jax.random.PRNGKey(4), 16, 4, 5
    want = j_parallel_ensemble(jp, key, num_walkers=walkers, num_samples=samples, num_warmup=warmup, move=move,
                               mesh=j_make_mesh(("walkers",)))
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], walkers))
    draws = _mesh_ensemble_draws(key, walkers, 8, 2, warmup, samples, 1, move)
    got = parallel_ensemble(tp, None, num_walkers=walkers, num_samples=samples, num_warmup=warmup, move=move,
                            starting_points=T(start), draws=draws, mesh=_cpu_mesh("walkers", 8))
    close(got.samples, want.samples)
    close(got.acceptance_rates, want.acceptance_rates)


@pytest.fixture(scope="module")
def normal_mean():
    """tests/test_parallel_dynamic_ibis.py's normal mean model and oracle."""
    data = np.random.default_rng(3).normal(0.8, 1.0, size=40)
    jdata, y = jnp.asarray(data), T(data)
    jp = j_define(parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th: jnp.sum(jd.Normal(th[0], 1.0).log_prob(
        jdata)), prior_distribution=jd.Product((jd.Normal(0.0, 2.0),)), validate=False)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)],
                                  log_likelihood=lambda th, v: td.Normal(th[0], 1.0).log_prob(v).sum(), data=y,
                                  prior_distribution=td.Product((td.Normal(T(0.0), T(2.0)),)), validate=False,
                                  device="cpu", dtype=torch.float64)
    post_var = 1.0 / (1.0 / 4.0 + data.size)
    grid = np.linspace(-10, 10, 4001)
    ll = (-0.5 * (data[None, :] - grid[:, None]) ** 2).sum(1) - data.size * 0.5 * math.log(2 * math.pi)
    lp = -0.5 * (grid / 2.0) ** 2 - math.log(2.0 * math.sqrt(2 * math.pi))
    log_z = float(np.logaddexp.reduce(ll + lp) + math.log(grid[1] - grid[0]))
    return dict(data=data, jp=jp, tp=tp, y=y, post_mean=post_var * data.sum(), post_var=post_var, log_z=log_z,
                j_pointwise=lambda th, v: jd.Normal(th[0], 1.0).log_prob(v),
                t_pointwise=lambda th, v: td.Normal(th[0], 1.0).log_prob(v))


def test_split_ibis_replays_the_jax_mesh_run(normal_mean):
    m = normal_mean
    key, n, steps, batch = jax.random.PRNGKey(5), 64, 4, 8
    want = j_parallel_ibis(m["jp"], m["j_pointwise"], jnp.asarray(m["data"]), key, n_particles=n, batch_size=batch,
                           mcmc_steps=steps)
    k_init, draws = _mesh_ibis_draws(key, n, 8, 1, steps, -(-m["data"].size // batch))
    start = np.asarray(m["jp"].prior_distribution.sample(k_init, (n,))).reshape(n, 1)
    got = parallel_ibis(m["tp"], m["t_pointwise"], m["y"], None, n_particles=n, batch_size=batch, mcmc_steps=steps,
                        starting_points=T(start), draws=draws, mesh=_cpu_mesh("particles", 8))
    np.testing.assert_array_equal(got.resampled.numpy(), np.asarray(want.resampled))
    assert got.resampled.any()
    for f in ("log_evidence", "log_predictives", "ess_history", "acceptance_history", "particles", "log_weights_"):
        close(getattr(got, f), getattr(want, f))


def test_split_dynamic_ns_meets_the_oracle_and_the_jax_engine(normal_mean):
    """tests/test_parallel_dynamic_ibis.py's oracle gates (8 batches of 8
    runs: one stage; pool 32 and 20 steps, for time), the runs on a mesh
    over two devices."""
    m = normal_mean
    kw = dict(sample_pool_size=32, num_batches=8, monte_carlo_steps=20, post_process_sampling_runs=50)
    mesh = make_mesh(("runs",), devices=["cpu"] * 4 + ["cpu:0"] * 4)
    got = parallel_dynamic_nested_sampling(m["tp"], torch.Generator().manual_seed(6), mesh=mesh, **kw)
    want = j_parallel_dns(m["jp"], jax.random.PRNGKey(6), mesh=j_make_mesh(("runs",)), **kw)
    mean, se = float(got.log_evidence.mean), float(got.log_evidence.standard_error)
    assert abs(mean - m["log_z"]) < 4 * se
    w = torch.exp(got.crude_log_posterior_weights).numpy()
    assert abs(float(w @ got.points[:, 0].numpy()) - m["post_mean"]) < 4 * math.sqrt(m["post_var"])
    j_mean, j_se = float(want.log_evidence.mean), float(want.log_evidence.standard_error)
    assert abs(mean - j_mean) < 4 * math.hypot(se, j_se), (mean, se, j_mean, j_se)


# --- the split runs against the one-batch runs (4 shards, the same draws)


@pytest.mark.parametrize("case", sorted(HMC_REPLAYS))
def test_split_hmc_matches_the_one_batch_run(case):
    _, tp = _problems()
    kw = dict(num_chains=8, num_warmup=6, num_samples=3, **HMC_REPLAYS[case])
    g = torch.Generator().manual_seed(7)
    x0 = 4.0 * torch.rand((8, 2), generator=g, dtype=torch.float64) - 2.0
    make = chees_draws if case == "auto" else hmc_draws
    draws = make(g, 8, 2, num_trajectories=sum(_phase_lengths(6)) + 3, dtype=torch.float64)
    one = parallel_hmc(tp, None, starting_points=x0, draws=draws, **kw)
    split = parallel_hmc(tp, None, starting_points=x0, draws=draws, mesh=_cpu_mesh("chains", 4), **kw)
    for f in HMC_FIELDS:
        assert _rel(getattr(split, f), getattr(one, f)) <= 1e-10, f
    assert torch.equal(split.divergences, one.divergences)


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_split_ensemble_is_the_one_batch_run(move):
    _, tp = _gauss_problems()
    g = torch.Generator().manual_seed(8)
    start = 2.0 * torch.rand((16, 2), generator=g, dtype=torch.float64) - 1.0
    draws = _stacked([ensemble_draws(g, 16, 2, move=move, dtype=torch.float64) for _ in range(7)])
    kw = dict(num_walkers=16, num_warmup=3, num_samples=4, move=move, starting_points=start, draws=draws)
    one = parallel_ensemble(tp, None, **kw)
    split = parallel_ensemble(tp, None, mesh=_cpu_mesh("walkers", 4), **kw)
    assert torch.equal(split.samples, one.samples) and torch.equal(split.acceptance_rates, one.acceptance_rates)


def test_split_ibis_matches_the_one_batch_run(normal_mean):
    m = normal_mean
    g = torch.Generator().manual_seed(9)
    start = 2.0 * torch.randn((128, 1), generator=g, dtype=torch.float64)
    draws = [ibis_stage_draws(g, 128, 1, 4, dtype=torch.float64) for _ in range(8)]
    kw = dict(n_particles=128, batch_size=5, mcmc_steps=4, starting_points=start, draws=draws)
    one = parallel_ibis(m["tp"], m["t_pointwise"], m["y"], None, **kw)
    split = parallel_ibis(m["tp"], m["t_pointwise"], m["y"], None, mesh=_cpu_mesh("particles", 4), **kw)
    assert torch.equal(split.resampled, one.resampled) and bool(one.resampled.any())
    for f in ("log_evidence", "log_predictives", "ess_history", "particles", "log_weights_"):
        assert _rel(getattr(split, f), getattr(one, f)) <= 1e-12, f


def test_split_dynamic_ns_on_one_device_is_the_one_batch_run(normal_mean):
    kw = dict(sample_pool_size=20, num_batches=4, batch_size=10, monte_carlo_steps=5, max_iterations=200,
              min_iterations=5, post_process_sampling_runs=5)
    tp = normal_mean["tp"]
    one = parallel_dynamic_nested_sampling(tp, torch.Generator().manual_seed(10), num_runs=4, **kw)
    split = parallel_dynamic_nested_sampling(tp, torch.Generator().manual_seed(10), mesh=_cpu_mesh("runs", 4), **kw)
    assert torch.equal(split.points, one.points) and float(split.log_evidence.mean) == float(one.log_evidence.mean)


# --- the GP slice on a 4-shard mesh against JAX on a 4-device mesh

GP_PARAMS = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]


@pytest.fixture(scope="module")
def gp_slice():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=64)
    jp = j_define_gp(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), GP_PARAMS,
                     nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3)
    tp = define_gaussian_process(T(x), T(y), lambda th: se_kernel(th[0] ** 2, th[1]), GP_PARAMS,
                                 nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3,
                                 device="cpu")
    return jp, tp, JMesh(np.asarray(jax.devices()[:4]), ("walkers",)), JMesh(np.asarray(jax.devices()[:4]),
                                                                             ("chains",))


def test_gp_slice_parallel_ensemble_on_four_shards_matches_jax(gp_slice):
    jp, tp, j_mesh, _ = gp_slice
    key, walkers, warmup, samples = jax.random.PRNGKey(12), 16, 2, 4
    want = j_parallel_ensemble(jp, key, num_walkers=walkers, num_samples=samples, num_warmup=warmup, mesh=j_mesh)
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], walkers))
    draws = _mesh_ensemble_draws(key, walkers, 4, 3, warmup, samples, 1, "stretch")
    got = parallel_ensemble(tp, None, num_walkers=walkers, num_samples=samples, num_warmup=warmup,
                            starting_points=T(start), draws=draws, mesh=_cpu_mesh("walkers", 4))
    close(got.samples, want.samples, rtol=1e-9)
    close(got.acceptance_rates, want.acceptance_rates, rtol=1e-9)
    assert 0 < float(got.acceptance_rates.mean())


def test_gp_slice_parallel_hmc_on_four_shards_matches_jax(gp_slice):
    jp, tp, _, j_mesh = gp_slice
    key, chains = jax.random.PRNGKey(13), 8
    kw = dict(num_samples=2, num_warmup=3, num_leapfrog=3)
    want = j_parallel_hmc(jp, key, num_chains=chains, mesh=j_mesh, **kw)
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], chains))
    draws = _mesh_hmc_draws(key, chains, 4, 3, kw["num_warmup"], kw["num_samples"], 1, False)
    got = parallel_hmc(tp, None, num_chains=chains, starting_points=T(start), draws=draws,
                       mesh=_cpu_mesh("chains", 4), **kw)
    for f in HMC_FIELDS:
        close(getattr(got, f), getattr(want, f), rtol=1e-9)


def test_problem_on_carries_a_gp_problem_whole(gp_slice):
    _, tp, _, _ = gp_slice
    moved = problem_on(tp, "meta")
    model = moved.metadata["gaussian_process"]
    assert model.x.device.type == "meta" and model.y.device.type == "meta" and moved.device.type == "meta"
    assert moved.log_likelihood.__self__ is model and tp.metadata["gaussian_process"].x.device.type == "cpu"
    assert all(c.low.device.type == "meta" for c in moved.prior_distribution.components)
    out = moved.guarded_log_likelihood(torch.zeros((5, 3), dtype=torch.float64, device="meta"))
    assert out.device.type == "meta" and out.shape == (5,)
    w = torch.ones(3, dtype=torch.float64)
    held = define_inference_problem(parameters=GP_PARAMS, log_likelihood=lambda th: (w * th).sum(),
                                    prior_distribution=["scale"] * 3, validate=False, device="cpu",
                                    dtype=torch.float64)
    with pytest.raises(ValueError, match=r"log_likelihood \(.*<lambda>\)\.w holds a tensor of shape \(3,\) on cpu"):
        problem_on(held, "meta")


# --- one copy per distinct device

MIXED = ["cpu"] + ["cpu:0"] * 3  # the home device, then three shards on one other device


def _counted(monkeypatch, module, name):
    """The devices (or arguments) of each call of ``module.name`` from here on."""
    calls, real = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[1] if name == "problem_on" else args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("engine", ["hmc", "ensemble", "ibis"])
def test_coupled_engines_copy_the_problem_once_a_device(engine, monkeypatch, normal_mean):
    calls = _counted(monkeypatch, _mesh, "problem_on")
    if engine == "hmc":
        parallel_hmc(_problems()[1], None, num_chains=8, num_warmup=3, num_samples=2, num_leapfrog=2,
                     mesh=make_mesh(("chains",), devices=MIXED))
    elif engine == "ensemble":
        parallel_ensemble(_gauss_problems()[1], None, num_walkers=16, num_warmup=1, num_samples=2,
                          mesh=make_mesh(("walkers",), devices=MIXED))
    else:
        m = normal_mean
        parallel_ibis(m["tp"], m["t_pointwise"], m["y"], None, n_particles=64, batch_size=10, mcmc_steps=2,
                      mesh=make_mesh(("particles",), devices=MIXED))
    assert [torch.device(d) for d in calls] == [torch.device("cpu"), torch.device("cpu:0")]


class _CountedCopies(torch.Tensor):
    copies = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            cls.copies += 1
        return super().__torch_function__(func, types, args, kwargs or {})


def test_shard_axis_sends_one_copy_a_device():
    shards = ShardAxis(MIXED, "cpu")
    t = torch.arange(3.0).as_subclass(_CountedCopies)
    _CountedCopies.copies = 0
    sent = shards.send(t)
    assert _CountedCopies.copies == 2 and sent[1] is sent[2] is sent[3] and torch.equal(sent[0], t)


def test_dynamic_ns_copies_the_problem_once_a_device_over_its_stages(monkeypatch, normal_mean):
    calls = _counted(monkeypatch, nested_sampling, "problem_on")
    stages = _counted(monkeypatch, dynamic_ns, "runs_by_device")
    out = parallel_dynamic_nested_sampling(normal_mean["tp"], torch.Generator().manual_seed(12),
                                           mesh=make_mesh(("runs",), devices=MIXED), sample_pool_size=20,
                                           num_batches=8, batch_size=10, monte_carlo_steps=5, max_iterations=200,
                                           min_iterations=5, post_process_sampling_runs=5)
    assert len(stages) == 3 and math.isfinite(float(out.log_evidence.mean))  # the base run and two stages
    assert [torch.device(d) for d in calls] == [torch.device("cpu"), torch.device("cpu:0")]
