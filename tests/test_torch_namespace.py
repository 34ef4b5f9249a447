"""The port's package namespaces against the JAX package's: every name in
the ``__all__`` of the JAX package and of each of its subpackages exists in
the port's namespace of the same name, less two named lists:

* ``UNPORTED``: modules still to port, each name tagged with its ROADMAP
  queue item;
* ``WORKAROUNDS``: names that exist only for the TPU or XLA and have no
  port (the Pallas entry point, which the port's custom op replaces; the
  mesh helpers of ``parallel/sharding.py``).

Stated departures, held here too: ``engines.nested_sampling`` is the
module in the port (the function in JAX, whose ``engines/__init__.py``
rebinds the name); ``core.numerics.logsumexp`` and ``logmeanexp`` take
``dim``/``keepdim`` (JAX ``axis``/``keepdims``) and
``ops.metropolis.chol_rank1_update`` takes ``chol`` (JAX ``L``);
``parallel.parallel_dynamic_nested_sampling`` takes ``num_runs`` (R, the
runs of a stage; JAX reads it from its mesh).
Importing the port builds no kernel; ``bnn``, ``utils`` and ``viz`` load at
first use.
"""

import importlib
import inspect
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

import bayesianinference_tpu_torch as bi

MULTI_CARD = "queue 1 item 7: the multi-card engines"

UNPORTED = {
    "parallel": {
        **dict.fromkeys(["sharded_bayesian_linear_regression", "sharded_categorical_conjugate_model",
                         "sharded_cholesky", "sharded_covariance_matrix", "sharded_gp_logml_blocked",
                         "sharded_gp_log_marginal_likelihood", "sharded_gp_predict",
                         "sharded_multinormal_conjugate_model", "sharded_normal_conjugate_model",
                         "sharded_pool_nested_sampling", "multi_axis_nested_sampling", "make_multi_axis_mesh"],
                        MULTI_CARD),
    },
}
# queue 1 items 4 and 5 (slices 13 and 14), ported together: the time-series
# engines, asserted here by name and by module
TIME_SERIES = {
    "engines": ["changepoint_probability", "define_changepoint_model", "run_length_posterior",
                "define_hidden_markov_model", "forecast_regime_probabilities", "most_likely_states",
                "regime_probabilities", "sample_hidden_paths", "SSMComponent", "ar_component",
                "define_state_space_model", "forecast_observations", "level_component", "seasonal_component",
                "sample_state_paths", "smoothed_states", "structural_lgssm", "trend_component", "IBISResult",
                "ibis_sampler", "PMMHResult", "pmmh_sample"],
    "ops": ["LGSSM", "FilterResult", "SmootherResult", "kalman_filter", "kalman_forecast", "kalman_log_likelihood",
            "kalman_sample", "kalman_smoother", "simulation_smoother", "BOCPDResult", "UPM", "bocpd",
            "changepoint_probabilities", "gaussian_upm", "poisson_upm", "HMM", "HMMFilterResult", "hmm_filter",
            "hmm_forecast", "hmm_log_likelihood", "hmm_posterior_sample", "hmm_sample_states", "hmm_smoother",
            "hmm_viterbi", "row_stochastic", "ParticleModel", "particle_filter", "particle_forecast",
            "particle_log_likelihood", "RBPFModel", "RBPFResult", "rbpf_filter", "rbpf_log_likelihood"],
}
TIME_SERIES_MODULES = ["ops.kalman", "ops.hmm", "ops.bocpd", "ops.particle", "ops.rbpf", "engines.ssm",
                       "engines.hmm", "engines.changepoint", "engines.particle", "engines.ibis"]
# queue 1 item 6: the single-card parallel engines, asserted by name and by module
PARALLEL = {"parallel_smc": "parallel_smc", "parallel_hmc": "parallel_hmc", "parallel_ensemble": "parallel_ensemble",
            "parallel_ibis": "parallel_ibis", "parallel_dynamic_nested_sampling": "parallel_dynamic_ns"}
WORKAROUNDS = {
    "ops": {"se_covariance_pallas": "the port's custom op ops.gp_kernels.se_covariance replaces the Pallas call"},
    "parallel": dict.fromkeys(["Mesh", "NamedSharding", "P", "make_mesh", "replicated", "shard_data"],
                              "jax.sharding's mesh helpers"),
}
SUBPACKAGES = ["", "bnn", "core", "dists", "engines", "models", "ops", "parallel", "results", "utils", "viz"]
THIS_SLICE = ["bnn", "dists", "results", "utils", "viz"]  # and core's betainc


def _modules(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module("bayesianinference_tpu" + suffix),
            importlib.import_module("bayesianinference_tpu_torch" + suffix))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "package" for s in SUBPACKAGES])
def test_every_jax_export_exists_in_the_port_less_the_named_lists(sub):
    jax_mod, port_mod = _modules(sub)
    listed = {**UNPORTED.get(sub, {}), **WORKAROUNDS.get(sub, {})}
    missing = [n for n in jax_mod.__all__ if n not in listed and not hasattr(port_mod, n)]
    assert not missing, f"{sub or 'package'}: {missing}"
    # the lists name only what the JAX package exports and the port lacks
    stale = [n for n in listed if n not in jax_mod.__all__ or hasattr(port_mod, n)]
    assert not stale, f"{sub or 'package'}: listed but exported or not in JAX: {stale}"


@pytest.mark.parametrize("sub", THIS_SLICE)
def test_this_slices_subpackages_export_everything(sub):
    jax_mod, port_mod = _modules(sub)
    assert not UNPORTED.get(sub) and not WORKAROUNDS.get(sub)
    assert set(jax_mod.__all__) <= set(port_mod.__all__)


SLICE_MODULES = ["dists.scalar", "dists.combinators", "dists.empirical", "dists.expfam", "results.posterior",
                 "results.scoring", "utils.config", "utils.validation", "utils.profiling", "bnn.nets", "bnn.losses",
                 "bnn.predict", "engines.flow_vi", "viz.plots"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_this_slices_modules_export_every_name_of_their_jax_module(module):
    jax_mod, port_mod = _modules(module)
    assert set(jax_mod.__all__) <= set(port_mod.__all__)
    assert all(hasattr(port_mod, n) for n in port_mod.__all__)


@pytest.mark.parametrize("sub", sorted(TIME_SERIES))
def test_the_time_series_names_are_exported(sub):
    jax_mod, port_mod = _modules(sub)
    names = TIME_SERIES[sub]
    assert set(names) <= set(jax_mod.__all__)
    assert all(hasattr(port_mod, n) for n in names)
    assert not set(names) & set(UNPORTED.get(sub, {}))


@pytest.mark.parametrize("module", TIME_SERIES_MODULES)
def test_the_time_series_modules_export_every_name_of_their_jax_module(module):
    jax_mod, port_mod = _modules(module)
    assert set(jax_mod.__all__) <= set(port_mod.__all__)
    assert all(hasattr(port_mod, n) for n in port_mod.__all__)
    imports = re.compile(r"^\s*(import|from)\s+(jax|bayesianinference_tpu\b(?!_torch))", re.M)
    assert not imports.search(Path(port_mod.__file__).read_text())


@pytest.mark.parametrize("name", sorted(PARALLEL))
def test_the_single_card_parallel_engines_are_exported(name):
    jax_mod, port_mod = _modules(f"parallel.{PARALLEL[name]}")
    assert name in jax_mod.__all__ and name in port_mod.__all__
    assert getattr(bi.parallel, name) is getattr(port_mod, name)
    assert name not in UNPORTED["parallel"]
    imports = re.compile(r"^\s*(import|from)\s+(jax|bayesianinference_tpu\b(?!_torch))", re.M)
    assert not imports.search(Path(port_mod.__file__).read_text())


def test_the_package_imports_its_subpackages_and_loads_utils_lazily():
    for name in ("bnn", "core", "dists", "engines", "models", "ops", "parallel", "results", "utils", "viz"):
        assert isinstance(getattr(bi, name), types.ModuleType)
    assert set(bi.__all__) >= set(importlib.import_module("bayesianinference_tpu").__all__)
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(bi, "nnets")


def test_importing_the_port_builds_no_kernel():
    code = ("import bayesianinference_tpu_torch as bi; from bayesianinference_tpu_torch import csrc; "
            "bi.engines, bi.ops, bi.dists, bi.results, bi.utils, bi.bnn, bi.viz; "
            "assert csrc.load_library.cache_info().currsize == 0; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_stated_departures():
    from bayesianinference_tpu_torch.engines import nested_sampling

    assert isinstance(bi.engines.nested_sampling, types.ModuleType)
    assert callable(nested_sampling.nested_sampling)
    assert {"dim", "keepdim"} <= set(inspect.signature(bi.core.logsumexp).parameters)
    assert {"dim", "keepdim"} <= set(inspect.signature(bi.core.logmeanexp).parameters)
    assert "chol" in inspect.signature(bi.ops.chol_rank1_update).parameters
    # R, the runs of a dynamic-NS stage, is the JAX mesh's "runs" axis size; on one card it is num_runs (default 1)
    import bayesianinference_tpu.parallel as jpar

    assert "num_runs" not in inspect.signature(jpar.parallel_dynamic_nested_sampling).parameters
    assert inspect.signature(bi.parallel.parallel_dynamic_nested_sampling).parameters["num_runs"].default == 1


# utils: the counterparts of tests/test_utils_gbm.py's checks, and profiling


def test_check_traceable_asks_whether_the_function_batches():
    import numpy as np
    import torch

    from bayesianinference_tpu_torch.utils import check_traceable

    assert check_traceable(lambda x: x * 2, (torch.ones(3),))
    with pytest.warns(UserWarning, match="does not batch"):
        assert not check_traceable(lambda x: np.sum(np.asarray(x)), (torch.ones(3),))
    with pytest.warns(UserWarning, match="does not batch"):
        assert not check_traceable(lambda x: x * 2 if x.sum().item() > 0 else x, (torch.ones(3),))
    with pytest.raises(TypeError, match="does not batch"):
        check_traceable(lambda x: x.sum().item(), (torch.ones(3),), warn_only=False)


def test_distribution_dimension():
    import torch

    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.utils import distribution_dimension

    assert distribution_dimension(dists.Normal(0.0, 1.0)) == 1
    assert distribution_dimension(dists.MultivariateNormal(torch.zeros(3), torch.eye(3))) == 3


def test_options_defaults_name_the_loops_keywords():
    from bayesianinference_tpu.utils import NestedSamplingOptions as JaxOptions
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling_loop
    from bayesianinference_tpu_torch.utils import EvidenceOptions, MCMCOptions, NestedSamplingOptions

    opts = NestedSamplingOptions()
    assert (opts.sample_pool_size, opts.max_iterations, opts.monte_carlo_steps, opts.termination_fraction) == (
        100, 10000, 200, 0.01)
    assert opts.loop_kwargs() == JaxOptions().loop_kwargs()
    assert set(opts.loop_kwargs()) <= set(inspect.signature(nested_sampling_loop).parameters)
    assert EvidenceOptions().post_process_sampling_runs == 100 and MCMCOptions().burn_in_period == 1000


def test_trace_writes_a_chrome_trace_and_timed_reports_seconds(tmp_path):
    import json

    import torch

    from bayesianinference_tpu_torch.utils import timed, trace

    with trace(str(tmp_path / "tr")) as path:
        torch.ones(64).cumsum(0)
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert Path(path).parent == tmp_path / "tr" and len(events) > 0
    with timed(sync=torch.ones(3)) as box:
        torch.ones(8).sum()
    assert box["seconds"] >= 0.0
