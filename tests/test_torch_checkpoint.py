"""Checkpoint and resume of the port's nested-sampling runs, against the JAX
package's file format, on the CPU in float64: a checkpoint written by
either package is loaded and resumed by the other; a resumed run leaves the
run it came from unchanged; ``checkpoint_every`` is respected by the
segmented run; result files round-trip and cross between the packages.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import checkpoint as jck
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import checkpoint as tck
from bayesianinference_tpu_torch.engines import nested_sampling as tns
from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
from bayesianinference_tpu_torch.models.problem import define_inference_problem

jns = importlib.import_module("bayesianinference_tpu.engines.nested_sampling")
torch.set_num_threads(1)
ANALYTIC = -math.log(100.0)
KW = dict(num_delete=5, monte_carlo_steps=20)
STEPS = dict(monte_carlo_steps=20)  # resume takes num_delete from the run


def _t_problem():
    return define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"], device="cpu", dtype=torch.float64)


def _j_problem():
    return j_define(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"], validate=False)


def _start(n=50, seed=0):
    return np.random.default_rng(seed).uniform(-5.0, 5.0, size=(n, 2))


def _snapshot(state):
    return {f: (v.clone() if isinstance(v, torch.Tensor) else v) for f, v in vars(state).items()}


def _assert_unchanged(state, snap):
    for f, v in snap.items():
        now = getattr(state, f)
        assert torch.equal(now, v) if isinstance(v, torch.Tensor) else now == v, f


def test_save_load_round_trip_and_resume_leaves_the_source_run_unchanged(tmp_path):
    problem = _t_problem()
    g = torch.Generator().manual_seed(0)
    run = tns.nested_sampling_loop(problem, _start(), g, max_iterations=10, min_iterations=10, **KW)
    path = tmp_path / "run.npz"
    tck.save_ns_run(path, run, g)
    loaded = tck.load_ns_run(path, device="cpu")
    assert (loaded.n_live, loaded.num_delete, loaded.capacity) == (50, 5, 50)
    for f, v in vars(run.state).items():
        got = getattr(loaded.state, f)
        assert (torch.equal(got, v) and got.dtype == v.dtype) if isinstance(v, torch.Tensor) else got == v, f

    snap = _snapshot(run.state)
    more = tck.resume_nested_sampling_loop(problem, run, g, extra_iterations=15, min_iterations=25, **STEPS)
    _assert_unchanged(run.state, snap)  # the loop writes the dead buffers in place: resume must own copies
    assert more.capacity == 125 and more.state.iteration == 26 and more.state.n_dead == 125
    assert torch.equal(more.state.dead_logl[:50], run.state.dead_logl)
    assert int(more.state.num_likelihood_evals) == 25 * 5 * 21
    # with no room to grow (pad 0) the source stays untouched too, and a set flag is cleared
    run.state.interrupted = True
    same = tck.resume_nested_sampling_loop(problem, run, g, extra_iterations=0, **STEPS)
    assert same.state.interrupted is False and same.state.dead_logl.data_ptr() != run.state.dead_logl.data_ptr()
    with pytest.raises(ValueError, match="shrink"):
        tck.resume_nested_sampling_loop(problem, run, g, extra_iterations=-3, **STEPS)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jrun = jns.nested_sampling_loop(_j_problem(), jnp.asarray(_start()), jax.random.PRNGKey(0),
                                    max_iterations=12, min_iterations=12, **KW)
    path = tmp_path / "jax_run.npz"
    jck.save_ns_run(path, jrun)
    run = tck.load_ns_run(path, device="cpu")
    s = run.state
    assert s.iteration == 13 and s.n_dead == 60 and s.live_points.dtype == torch.float64
    np.testing.assert_array_equal(s.dead_logl.numpy(), np.asarray(jrun.state.dead_logl))
    assert int(s.num_likelihood_evals) == jns.evals_to_int(jrun.state.num_likelihood_evals) == 12 * 5 * 21
    done = tck.resume_nested_sampling_loop(_t_problem(), run, torch.Generator().manual_seed(1),
                                           extra_iterations=400, min_iterations=50, **STEPS)
    assert 50 <= done.state.iteration - 1 < 412, "the resumed run must end by its evidence criterion"
    assert torch.equal(done.state.dead_logl[:60], s.dead_logl[:60])
    assert abs(float(done.state.log_z) - ANALYTIC) < 0.6  # crude logZ, pool 50: sigma about 0.24


def test_old_scalar_eval_counter_loads(tmp_path):
    g = torch.Generator().manual_seed(0)
    run = tns.nested_sampling_loop(_t_problem(), _start(20), g, max_iterations=3, min_iterations=3,
                                   num_delete=2, monte_carlo_steps=4)
    path = tmp_path / "run.npz"
    tck.save_ns_run(path, run)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    assert arrays["num_likelihood_evals"].shape == (2,) and arrays["num_likelihood_evals"].dtype == np.int32
    arrays["num_likelihood_evals"] = np.asarray(2**31 + 5)  # the format before the (hi, lo) pair
    np.savez_compressed(path, **arrays)
    assert int(tck.load_ns_run(path, device="cpu").state.num_likelihood_evals) == 2**31 + 5


def test_port_checkpoint_resumes_in_jax(tmp_path):
    g = torch.Generator().manual_seed(3)
    run = tns.nested_sampling_loop(_t_problem(), _start(), g, max_iterations=12, min_iterations=12, **KW)
    path = tmp_path / "torch_run.npz"
    tck.save_ns_run(path, run, g)
    jrun = jck.load_ns_run(path)
    assert int(jrun.state.iteration) == 13 and int(jrun.state.n_dead) == 60 and jrun.capacity == 60
    assert jrun.state.key.shape == (2,) and jrun.state.key.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(jrun.state.live_logl), run.state.live_logl.numpy())
    done = jck.resume_nested_sampling_loop(_j_problem(), jrun, extra_iterations=400, min_iterations=50,
                                           monte_carlo_steps=20, monte_carlo_method="adaptive_metropolis")
    its = int(done.state.iteration) - 1
    assert 50 <= its < 412
    np.testing.assert_array_equal(np.asarray(done.state.dead_logl[:60]), run.state.dead_logl.numpy())
    assert abs(float(done.state.log_z) - ANALYTIC) < 0.6
    assert jns.evals_to_int(done.state.num_likelihood_evals) == its * 5 * 21


def test_checkpoint_every_respected(tmp_path):
    """``checkpoint_every`` must not be silently extended by ``min_iterations``
    (tests/test_review_regressions.py), and the file on disk is the last
    segment's."""
    path = tmp_path / "seg.npz"
    calls = []
    res = tns.nested_sampling(_t_problem(), torch.Generator().manual_seed(0), sample_pool_size=30,
                              max_iterations=60, min_iterations=60, monte_carlo_steps=20,
                              checkpoint_path=path, checkpoint_every=10, progress_interval=1,
                              progress_callback=lambda it, *rest: calls.append(it))
    run = tck.load_ns_run(path, device="cpu")
    assert run.state.iteration - 1 == 60 and run.capacity == 60
    assert res.generated_nested_samples == 60 and res.iterations == 60
    assert calls == list(range(1, 61))  # loop options reach every segment


@pytest.mark.parametrize("method,dim", [("slice", 2), ("chmc", 2), ("auto", 18)])
def test_segmented_run_keeps_its_method_and_ends_like_one_run(tmp_path, method, dim):
    """Every segment runs the chains the first one ran (the recorded
    acceptance is slice's moved fraction or chmc's accepted fraction, never
    an adaptive-Metropolis rate), and a run cut into segments ends by the
    evidence criterion like an uncut one."""
    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim, device="cpu", dtype=torch.float64)
    steps = {"slice": 8, "chmc": 32, "auto": 18}[method]
    kw = dict(sample_pool_size=40, num_delete=8, monte_carlo_steps=steps, monte_carlo_method=method,
              min_iterations=10, max_iterations=25 if dim > 2 else 300)
    path = tmp_path / "seg.npz"
    res = tns.nested_sampling(problem, torch.Generator().manual_seed(0), checkpoint_path=path,
                              checkpoint_every=7, **kw)
    run = tck.load_ns_run(path, device="cpu")
    assert run.state.iteration - 1 == res.iterations and run.state.n_dead == res.generated_nested_samples
    acc = run.state.dead_acc[: run.state.n_dead]
    units = {"slice": steps, "chmc": steps // 16, "auto": steps}[method]
    assert bool(((acc * units - (acc * units).round()).abs() < 1e-9).all()), "another chain kind wrote these rates"
    if dim == 2:
        assert res.iterations < 300
        logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
        assert abs(logz - ANALYTIC) <= 4 * err, (logz, err)
    else:
        assert res.iterations == 25


def test_result_files_round_trip_and_cross_packages(tmp_path):
    problem = _t_problem()
    res = tns.nested_sampling(problem, torch.Generator().manual_seed(0), sample_pool_size=30, num_delete=3,
                              monte_carlo_steps=10, max_iterations=30, min_iterations=30,
                              post_process_sampling_runs=8)
    path = tmp_path / "res.npz"
    tck.save_result(path, res)
    back = tck.load_result(path, device="cpu")
    jback = jck.load_result(path)  # the JAX package reads the port's file
    for f in ("points", "log_likelihoods", "crude_log_posterior_weights", "acceptance_rates"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(res, f).numpy())  # NaN equals NaN here
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)), getattr(res, f).numpy())
    assert torch.equal(back.log_evidence.mean, res.log_evidence.mean)
    assert back.param_names == ("x", "y") == jback.param_names and back.iterations == 30 == jback.iterations
    assert back.num_likelihood_evals == res.num_likelihood_evals and back.sample_pool_size == 30

    jck.save_result(path, jback)  # and the port reads the JAX package's
    again = tck.load_result(path, device="cpu")
    np.testing.assert_array_equal(again.points.numpy(), res.points.numpy())
    np.testing.assert_array_equal(again.log_evidence.standard_error.numpy(), res.log_evidence.standard_error.numpy())

    fit = laplace_posterior_fit(problem=problem, initial_guess=torch.tensor([[0.3, -0.2]], dtype=torch.float64))
    tck.save_result(path, fit)
    fit_back = tck.load_result(path, device="cpu")
    assert torch.equal(fit_back.mean, fit.mean) and torch.equal(fit_back.precision_matrix, fit.precision_matrix)
    assert float(fit_back.log_evidence) == float(fit.log_evidence) and fit_back.param_names == ("x", "y")
    np.testing.assert_array_equal(np.asarray(jck.load_result(path).mean), fit.mean.numpy())


def test_result_types_of_unported_engines_raise_naming_the_module(tmp_path):
    path = tmp_path / "smc.npz"
    np.savez_compressed(path, __meta__=np.frombuffer(b'{"__class__": "SMCResult"}', dtype=np.uint8))
    with pytest.raises(NotImplementedError, match="engines/smc.py"):
        tck.load_result(path, device="cpu")

    class HMCResult:  # stands for the JAX package's result of an engine the port lacks
        pass

    with pytest.raises(NotImplementedError, match="engines/hmc.py"):
        tck.save_result(path, HMCResult())
