"""Nested sampling above d = 16 in the port, against the JAX package, on the
CPU in float64.

Exactly: the policy functions and both warnings at the cases of
``tests/test_nested_sampling.py`` (the ``auto`` dispatch, the lazy gradient
probe, the chmc step law, the slice and chmc step-count warnings) and
``gradient_sanity``.  Whole runs (threefry and Philox cannot match bit for
bit): slice and chmc runs of the 2-D oracle and a d = 20 slice run must
land within 4 standard errors of the analytic logZ and within 4 combined
standard errors of the JAX engine's result on the same problem.  The GP
with ARD lengthscales (20 hyperparameters, so ``auto`` takes the slice
chains) runs two iterations of each method through the plain versions of
both kernels; its logML and the gradient of its logML at the final live
points match the JAX package to 1e-8 relative.
"""

import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu.models import problem as jproblem_mod
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import nested_sampling as tns
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
from bayesianinference_tpu_torch.interop import problem_data_from_numpy
from bayesianinference_tpu_torch.models import problem as tproblem_mod
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

jns = importlib.import_module("bayesianinference_tpu.engines.nested_sampling")
torch.set_num_threads(1)
A = 5.0


def _analytic(dim):
    return dim * (math.log(erf(A / math.sqrt(2))) - math.log(2 * A))


def _t_problem(dim):
    return define_inference_problem(
        parameters=[(f"x{i}", -A, A) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim, device="cpu", dtype=torch.float64, validate=False,
    )


def _j_problem(dim):
    return j_define(
        parameters=[(f"x{i}", -A, A) for i in range(dim)],
        log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim, validate=False,
    )


# --- the policy, exactly

@pytest.mark.parametrize("method,dim,want", [
    ("auto", 2, "adaptive_metropolis"), ("auto", 16, "adaptive_metropolis"), ("auto", 17, "slice"),
    ("auto", 64, "slice"), ("auto", 65, "slice"), ("slice", 2, "slice"),
    ("adaptive_metropolis", 64, "adaptive_metropolis"), ("chmc", 64, "chmc"),
])
def test_resolve_method_without_probe_matches_jax(method, dim, want):
    assert tns.resolve_monte_carlo_method(method, dim) == want == jns.resolve_monte_carlo_method(method, dim)


def test_resolve_method_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown monte_carlo_method"):
        tns.resolve_monte_carlo_method("hmc", 4)


def test_auto_chmc_above_crossover_needs_gradient_probe():
    resolve = tns.resolve_monte_carlo_method
    assert resolve("auto", 64, gradient_check=lambda: True) == "slice"
    assert resolve("auto", 65, gradient_check=lambda: True) == "chmc"
    with pytest.warns(UserWarning, match="gradient probe failed"):
        assert resolve("auto", 65, gradient_check=lambda: False) == "slice"

    def boom():
        raise AssertionError("the probe must not run below the crossover")

    assert resolve("auto", 8, gradient_check=boom) == "adaptive_metropolis"
    assert resolve("auto", 32, gradient_check=boom) == "slice"


@pytest.mark.parametrize("dim", [1, 2, 4, 16, 64, 65, 72, 256])
def test_chmc_and_step_laws_match_jax(dim):
    assert tns.default_chmc_step_size(dim) == jns.default_chmc_step_size(dim)
    assert tns.default_chmc_num_leapfrog(dim) == jns.default_chmc_num_leapfrog(dim)
    for method in ("adaptive_metropolis", "slice", "chmc"):
        assert tns.default_monte_carlo_steps(method, dim) == jns.default_monte_carlo_steps(method, dim)


@pytest.mark.parametrize("method,steps,dim,n_leap,warns", [
    ("slice", 50, 64, None, True), ("slice", 64, 64, None, False), ("slice", (10, 10, 50), 20, None, True),
    ("adaptive_metropolis", 5, 64, None, False),
    ("chmc", 48, 128, None, True),  # 12 four-step trajectories at d = 128
    ("chmc", 768, 128, None, False), ("chmc", 768, 128, 16, True), ("chmc", 8, 64, None, False),
])
def test_step_count_warning_matches_jax(method, steps, dim, n_leap, warns):
    for fn in (tns.warn_if_slice_steps_below_dim, jns.warn_if_slice_steps_below_dim):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(method, steps, dim, n_leap)
        assert bool(caught) == warns, (fn.__module__, [str(w.message) for w in caught])
        if warns:
            assert "replacement at d=" in str(caught[0].message)


def test_gradient_sanity_probe():
    box = [(f"x{i}", -5.0, 5.0) for i in range(3)]
    kw = dict(prior_distribution=["location"] * 3, validate=False, device="cpu", dtype=torch.float64)
    smooth = define_inference_problem(parameters=box, log_likelihood=lambda th: -0.5 * torch.sum(th * th), **kw)
    assert smooth.gradient_sanity() is True
    rounded = define_inference_problem(parameters=box, log_likelihood=lambda th: -torch.sum(torch.round(th) ** 2), **kw)
    assert rounded.gradient_sanity() is False
    assert rounded._gradient_sanity_cache is False and rounded.gradient_sanity() is False
    # no path from theta to the value, a NaN gradient, an exception: all "no usable gradient"
    for bad in (lambda th: torch.zeros(()).double(), lambda th: torch.sqrt(th[0] - 10.0), lambda th: 1 / 0):
        assert define_inference_problem(parameters=box, log_likelihood=bad, **kw).gradient_sanity() is False
    # half-open and open axes take the +-0.7 probes, clipped to the bounds
    open_box = define_inference_problem(
        parameters=[("a", -math.inf, math.inf), ("b", 0.0, math.inf), ("c", -1.0, 1.0)],
        log_likelihood=lambda th: -0.5 * torch.sum((th - 0.7) ** 2), validate=False, device="cpu",
        dtype=torch.float64)
    assert open_box.gradient_sanity() is True
    assert _t_problem(72).gradient_sanity() is True and _j_problem(72).gradient_sanity() is True


def test_likelihood_closure_helpers_match_jax():
    rng = np.random.default_rng(0)
    data, x = rng.normal(1.0, 2.0, size=30), np.linspace(-1, 1, 30)
    th = np.array([0.8, 1.7])
    t_iid = tproblem_mod.iid_likelihood(lambda t: Normal(t[0], t[1]), data, device="cpu")
    j_iid = jproblem_mod.iid_likelihood(lambda t: jd.Normal(t[0], t[1]), data)
    np.testing.assert_allclose(float(t_iid(torch.tensor(th))), float(j_iid(jnp.asarray(th))), rtol=1e-12)
    t_reg = tproblem_mod.regression_likelihood(lambda t, xs: Normal(t[0] * xs, t[1]), x, data, device="cpu")
    j_reg = jproblem_mod.regression_likelihood(lambda t, xs: jd.Normal(t[0] * xs, t[1]), x, data)
    np.testing.assert_allclose(float(t_reg(torch.tensor(th))), float(j_reg(jnp.asarray(th))), rtol=1e-12)
    # usable as a problem's per-point likelihood, batched by the problem
    problem = define_inference_problem(parameters=[("m", -5.0, 5.0), ("s", 0.1, 5.0)], log_likelihood=t_iid,
                                       prior_distribution=["location", "scale"], device="cpu", dtype=torch.float64)
    assert problem.guarded_log_likelihood(torch.tensor(np.stack([th, th + 0.1]))).shape == (2,)
    if not torch.cuda.is_available():  # plain data goes to the card, and there is none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tproblem_mod.iid_likelihood(lambda t: Normal(t[0], t[1]), data)


# --- whole runs against the oracle and the JAX engine

RUNS = {
    "slice_2d": dict(dim=2, pool=100, kw=dict(num_delete=10, monte_carlo_steps=10, monte_carlo_method="slice",
                                              max_iterations=400, min_iterations=50)),
    "chmc_2d": dict(dim=2, pool=100, kw=dict(num_delete=10, monte_carlo_steps=32, monte_carlo_method="chmc",
                                             max_iterations=400, min_iterations=50)),
    "slice_20d_auto": dict(dim=20, pool=100, kw=dict(num_delete=20, monte_carlo_steps=40, max_iterations=400,
                                                     min_iterations=50)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_whole_run_hits_oracle_and_agrees_with_jax(name):
    cfg = RUNS[name]
    dim, want = cfg["dim"], _analytic(cfg["dim"])
    res = tns.nested_sampling(_t_problem(dim), torch.Generator().manual_seed(1), sample_pool_size=cfg["pool"],
                              post_process_sampling_runs=50, **cfg["kw"])
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert math.isfinite(logz) and 0 < err < 1.0
    assert abs(logz - want) <= 4 * err, (logz, err, want)
    assert res.iterations < 400, "the run must end by its evidence criterion"
    acc = res.acceptance_rates[: res.generated_nested_samples]
    assert bool((acc >= 0).all() & (acc <= 1).all()) and float(acc.mean()) > 0.3
    jres = jns.nested_sampling(_j_problem(dim), jax.random.PRNGKey(1), sample_pool_size=cfg["pool"],
                               post_process_sampling_runs=50, **cfg["kw"])
    jlogz, jerr = float(jres.log_evidence.mean), float(jres.log_evidence.standard_error)
    assert abs(logz - jlogz) <= 4 * math.hypot(err, jerr), (logz, err, jlogz, jerr)
    # the same chains cost about the same number of likelihood evaluations per iteration
    per_it, j_per_it = res.num_likelihood_evals / res.iterations, jres.num_likelihood_evals / jres.iterations
    if cfg["kw"].get("monte_carlo_method") == "chmc":
        assert per_it == j_per_it == 10 * (2 * 32 + 1)
    else:
        assert 0.8 < per_it / j_per_it < 1.25, (per_it, j_per_it)


def test_loop_options_stop_level_and_chmc_overrides():
    problem = _t_problem(2)
    g = torch.Generator().manual_seed(0)
    start = tns.generate_starting_points(problem, g, 60)
    run = tns.nested_sampling_loop(problem, start, g, num_delete=6, monte_carlo_steps=8, monte_carlo_method="slice",
                                   min_iterations=1, max_iterations=500, stop_at_log_likelihood=-2.5)
    s = run.state
    # the batch rule: it went on while the next threshold was at most the level, and not one iteration longer
    assert 1 < s.iteration - 1 < 500
    assert float(s.live_logl[5]) > -2.5 and float(s.dead_logl[s.n_dead - 1]) <= -2.5
    # 24 steps as 3 trajectories of 8: recorded acceptance in thirds, evals 2 * 3 * 8 + 1 per replacement
    run = tns.nested_sampling_loop(problem, start, g, num_delete=6, monte_carlo_steps=24, monte_carlo_method="chmc",
                                   chmc_num_leapfrog=8, chmc_step_size=0.25, min_iterations=3, max_iterations=3)
    acc = run.state.dead_acc[:18] * 3
    assert bool(((acc - acc.round()).abs() < 1e-12).all())
    assert int(run.state.num_likelihood_evals) == 3 * 6 * (2 * 3 * 8 + 1)
    assert bool((run.state.live_logl[:-1] <= run.state.live_logl[1:]).all())
    assert bool((run.state.live_logl >= run.state.dead_logl[:18].max()).all())


# --- the GP with ARD lengthscales: 20 hyperparameters

GP_N, GP_D = 32, 18
GP_PARAMS = [("amp", 0.05, 5.0)] + [(f"len{i}", 0.05, 5.0) for i in range(GP_D)] + [("noise", 0.01, 1.0)]


@pytest.fixture(scope="module")
def ard_gp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(GP_N, GP_D))
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] + 0.1 * rng.normal(size=GP_N)
    xt, yt = problem_data_from_numpy(x, y, device="cpu", dtype=torch.float64)
    problem = define_gaussian_process(
        xt, yt, kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1:1 + GP_D]),
        nugget_builder=lambda th: th[-1] ** 2, parameters=GP_PARAMS, prior_distribution=["scale"] * len(GP_PARAMS))
    jproblem = j_define_gp(
        jnp.asarray(x), jnp.asarray(y), kernel_builder=lambda th: jgk.se_kernel(th[0] ** 2, th[1:1 + GP_D]),
        nugget_builder=lambda th: th[-1] ** 2, parameters=GP_PARAMS, prior_distribution=["scale"] * len(GP_PARAMS))
    return problem, jproblem


@pytest.mark.parametrize("method,steps", [("auto", 6), ("chmc", 8)])
def test_ard_gp_two_iterations_logml_and_gradient_match_jax(ard_gp, method, steps):
    problem, jproblem = ard_gp
    assert problem.dim == 20 and tns.resolve_monte_carlo_method("auto", problem.dim) == "slice"
    g = torch.Generator().manual_seed(2)
    start = tns.generate_starting_points(problem, g, 24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 6 slice updates at d = 20: the short run is the point
        run = tns.nested_sampling_loop(problem, start, g, num_delete=4, monte_carlo_steps=steps,
                                       monte_carlo_method=method, chmc_num_leapfrog=4, min_iterations=2,
                                       max_iterations=2)
    s = run.state
    assert s.n_dead == 8 and s.iteration == 3
    per_chain = 2 * (steps // 4) * 4 + 1 if method == "chmc" else None
    if per_chain:
        assert int(s.num_likelihood_evals) == 2 * 4 * per_chain
    # every replacement lies in the box, above the last threshold it was drawn under
    assert bool(problem.in_support(s.live_points).all())
    assert bool((s.live_logl > s.dead_logl[7]).sum() >= 24 - 4)
    pts = s.live_points.detach().clone().requires_grad_(True)
    logml = problem.guarded_log_likelihood(pts)
    (grad,) = torch.autograd.grad(logml.sum(), pts)
    jp = jnp.asarray(s.live_points.numpy())
    want = jax.vmap(jproblem.guarded_log_likelihood)(jp)
    want_grad = jax.vmap(jax.grad(jproblem.guarded_log_likelihood))(jp)
    np.testing.assert_allclose(logml.detach().numpy(), np.asarray(want), rtol=1e-8)
    np.testing.assert_allclose(s.live_logl.numpy(), np.asarray(want), rtol=1e-8)
    scale = np.abs(np.asarray(want_grad)).max()
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-8, atol=1e-8 * scale)
    assert np.isfinite(grad.numpy()).all() and scale > 0
