"""The port's GP regression example (``examples_torch/03_gaussian_process.py``)
against the JAX example on the CPU, through the kernels' plain versions:
nested sampling of the hyperparameters, then the mixed predictive at the 80
plotted points.

Tier-1: both examples run whole but for their fit, which one short JAX
nested-sampling run of the example's own problem stands in for; the port's
example loads that run's ``save_result`` artifact, so the two mixed
predictives come from one hyperparameter posterior and agree to 1e-10.

Slow: both examples run whole.  The two runs draw different numbers, so the
log evidences agree within 3 combined standard errors and the port's
predictive mean lies within the JAX posterior predictive's sd at every
plotted point.  The example has no smoke sizes (neither package's 03 reads
them): this takes about 400 s on one CPU core (the port's NS loop is
host-bound), so it is marked slow: in the Tier-1 run it lengthened the
suite's wall from about 720 s to 1210 s."""

import glob
import importlib
import math
import os
import runpy
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))
import gates  # noqa: E402


@pytest.fixture
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gp_example_predictive_matches_the_jax_example_on_one_posterior(monkeypatch, tmp_path, one_thread):
    import bayesianinference_tpu.engines as jax_engines
    from bayesianinference_tpu.engines import save_result

    from bayesianinference_tpu_torch.engines import load_result

    port_ns = importlib.import_module("bayesianinference_tpu_torch.engines.nested_sampling")
    artifact, asked = str(tmp_path / "posterior.npz"), {}
    real = jax_engines.nested_sampling

    def short_jax_fit(problem, key, **kw):  # the example's own problem, a short run
        asked["jax"] = kw
        res = real(problem, key, sample_pool_size=24, monte_carlo_steps=10, max_iterations=300)
        save_result(artifact, res)
        return res

    def port_fit(problem, generator, **kw):
        asked["port"] = kw
        assert problem.device.type == "cpu" and generator.device.type == "cpu"
        return load_result(artifact, device="cpu")

    (jax_path,) = glob.glob(os.path.join(ROOT, "examples", "03_*.py"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_engines, "nested_sampling", short_jax_fit)
    want = runpy.run_path(jax_path, run_name="__main__")
    monkeypatch.setattr(port_ns, "nested_sampling", port_fit)
    got = gates.run_example("03", "cpu")

    assert asked["port"] == asked["jax"] == {"sample_pool_size": 100, "monte_carlo_steps": 100,
                                              "max_iterations": 1500}
    np.testing.assert_array_equal(gates.arr(got["x"]), np.asarray(want["x"]))
    np.testing.assert_array_equal(gates.arr(got["xq"]), np.asarray(want["xq"]))
    assert gates.mean_err(got["result"].log_evidence) == gates.mean_err(want["result"].log_evidence)
    for moment in ("mean", "variance"):
        a, b = gates.arr(getattr(got["pred"], moment)()), np.asarray(getattr(want["pred"], moment)())
        assert a.shape == b.shape == (80,)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12, err_msg=moment)


@pytest.mark.slow
def test_gp_example_matches_the_jax_example(monkeypatch, tmp_path, one_thread):
    (jax_path,) = glob.glob(os.path.join(ROOT, "examples", "03_*.py"))
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    monkeypatch.chdir(tmp_path)
    want = runpy.run_path(jax_path, run_name="__main__")
    monkeypatch.setenv("BI_EXAMPLE_DEVICE", "cpu")
    got = gates.run_example("03")

    assert got["result"].points.device.type == "cpu"
    (a, sa), (b, sb) = gates.mean_err(got["result"].log_evidence), gates.mean_err(want["result"].log_evidence)
    assert abs(a - b) <= 3 * math.hypot(sa, sb), (a, sa, b, sb)
    np.testing.assert_array_equal(gates.arr(got["xq"]), np.asarray(want["xq"]))
    mean_port = gates.arr(got["pred"].mean())
    mean_jax, sd_jax = np.asarray(want["pred"].mean()), np.sqrt(np.asarray(want["pred"].variance()))
    assert np.all(np.abs(mean_port - mean_jax) <= sd_jax), np.max(np.abs(mean_port - mean_jax) / sd_jax)
    assert gates.CHECKS["03"](got, True, None)
