"""The port's serving example (``examples_torch/10_serving_roundtrip.py``)
against the JAX example on the CPU, at smoke size: the fit, its artifact
reloaded and served by a fresh interpreter, and the fit-per-request loop
through ``problem.with_data``.  Each request's data are the same numpy draws
in both packages, so each request's ``mu_hat`` lies within the posterior sd
(1 / sqrt(64) = 0.125) of the JAX example's for the same request.  About
280 s on one CPU core (five host-bound NS fits), so it is marked slow.

Tier-1: both examples run whole but for their five fits, for which the JAX
example 10's own saved posterior (``examples_torch/data/
jax_serving_posterior.npz``) stands in.  Each fit is asked for with the same
settings, each request's problem from ``with_data`` holds the same data and
the same log posterior density on a grid of 25 points (1e-12), and the
fresh interpreters serve the same quantiles."""

import glob
import importlib
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


def _quantiles(stdout):
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("posterior-predictive quantiles:")]
    return np.array([float(v) for v in line.split(":")[1].strip(" []").split()])


def test_serving_example_with_data_loop_matches_the_jax_example(monkeypatch, tmp_path, one_thread):
    import jax
    import jax.numpy as jnp

    import bayesianinference_tpu.engines as jax_engines
    from bayesianinference_tpu.engines import load_result as jax_load

    from bayesianinference_tpu_torch.engines import load_result

    port_ns = importlib.import_module("bayesianinference_tpu_torch.engines.nested_sampling")
    artifact = os.path.join(ROOT, "examples_torch", "data", "jax_serving_posterior.npz")
    grid = np.stack(np.meshgrid(np.linspace(-2.5, 2.5, 5), np.linspace(-1.5, 1.5, 5)), -1).reshape(-1, 2)
    fits = {"jax": [], "port": []}

    def jax_fit(problem, key, **kw):
        fits["jax"].append((kw, np.asarray(problem.data),
                            np.asarray(jax.vmap(problem.log_posterior_density)(jnp.asarray(grid)))))
        return jax_load(artifact)

    def port_fit(problem, generator, **kw):
        assert problem.device.type == "cpu" and generator.device.type == "cpu"
        fits["port"].append((kw, gates.arr(problem.data), gates.arr(problem.log_posterior_density(grid))))
        return load_result(artifact, device="cpu")

    (jax_path,) = glob.glob(os.path.join(ROOT, "examples", "10_*.py"))
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_engines, "nested_sampling", jax_fit)
    want = runpy.run_path(jax_path, run_name="__main__")
    monkeypatch.setattr(port_ns, "nested_sampling", port_fit)
    got = gates.run_example("10", "cpu")

    # the serving fit, the first fit and three requests, each asked for alike
    assert len(fits["port"]) == len(fits["jax"]) == 5
    for i, ((kw, data, dens), (jkw, jdata, jdens)) in enumerate(zip(fits["port"], fits["jax"])):
        assert kw == jkw, (i, kw, jkw)
        np.testing.assert_array_equal(data, jdata, err_msg=f"fit {i}")
        np.testing.assert_allclose(dens, jdens, rtol=1e-12, err_msg=f"fit {i}")
    assert float(got["true_mus"][-1]) == float(want["true_mu"]) and got["mu_hat"] == float(want["mu_hat"])
    # both fresh interpreters loaded the same posterior and served the same quantiles
    assert got["out"].returncode == want["out"].returncode == 0, got["out"].stderr
    np.testing.assert_allclose(_quantiles(got["out"].stdout), _quantiles(want["out"].stdout), atol=1.5e-3)


@pytest.mark.slow
def test_serving_example_matches_the_jax_example(monkeypatch, tmp_path, one_thread, capsys):
    (jax_path,) = glob.glob(os.path.join(ROOT, "examples", "10_*.py"))
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    monkeypatch.chdir(tmp_path)
    runpy.run_path(jax_path, run_name="__main__")
    # the JAX example keeps only the last request's numbers as globals: read all three from its printed lines
    # ("request i: fit ... mu_hat +x.xx (truth +y.yy)", two decimals)
    requests = [line for line in capsys.readouterr().out.splitlines() if line.startswith("request ")]
    monkeypatch.setenv("BI_EXAMPLE_DEVICE", "cpu")
    got = gates.run_example("10")

    # the round trip through a fresh interpreter, on the device the example was asked for
    assert got["out"].returncode == 0, got["out"].stderr
    assert "loaded: logZ =" in got["out"].stdout and "posterior-predictive quantiles" in got["out"].stdout
    # the fit-per-request loop: the same requests, each mu_hat within the posterior sd of JAX's
    request_truths = [float(v) for v in got["true_mus"]]
    jax_truths = [float(line.split("truth ")[1].rstrip(")")) for line in requests]
    np.testing.assert_allclose(request_truths, jax_truths, atol=0.005)  # JAX prints them to 2 decimals
    jax_mu = [float(line.split("mu_hat ")[1].split()[0]) for line in requests]
    assert len(got["mu_hats"]) == len(jax_mu) == 3
    for mine, theirs in zip(got["mu_hats"], jax_mu):
        assert abs(mine - theirs) <= 0.125 + 0.005, (mine, theirs)
    assert gates.CHECKS["10"](got, True, None)

