"""The port's entry points put new state on the CUDA card unless the caller
asks for the CPU, and raise where there is no card (no fallback to the
host).  Each test decides inside itself whether a card is present."""

import numpy as np
import pytest
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.interop import am_state_from_numpy, ns_state_from_numpy, problem_data_from_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem


def _ns_arrays():
    c, n, d = 6, 4, 2
    arrays = {name: np.zeros(shape) for name, shape in (
        ("live_points", (n, d)), ("live_logl", (n,)), ("live_logp", (n,)), ("dead_points", (c, d)),
        ("dead_logl", (c,)), ("dead_logp", (c,)), ("dead_acc", (c,)), ("mean_est", (d,)),
        ("cov_est", (d, d)), ("log_z", ()), ("entropy", ()), ("log_missing", ()))}
    arrays.update(n_dead=0, iteration=0, num_likelihood_evals=np.asarray([0, 7], np.int32))
    return arrays


def _am_arrays():
    return {"x": np.zeros((3, 2)), "log_density": np.zeros(3), "mean": np.zeros((3, 2)),
            "chol": np.broadcast_to(np.eye(2), (3, 2, 2)), "step": np.zeros(3, np.int64),
            "accepted": np.zeros(3, np.int64), "proposed": np.zeros(3, np.int64)}


# each entry point called without tensor data; returns one tensor it made
ENTRY_POINTS = {
    "define_inference_problem": lambda **kw: define_inference_problem(
        parameters=[("a", -1.0, 1.0)], log_likelihood=lambda th: -0.5 * torch.sum(th**2),
        prior_distribution=["location"], dtype=torch.float64, **kw).lower,
    "problem_data_from_numpy": lambda **kw: problem_data_from_numpy(np.zeros((5, 2)), np.zeros(5), **kw)[1],
    "ns_state_from_numpy": lambda **kw: ns_state_from_numpy(_ns_arrays(), **kw).num_likelihood_evals,
    "am_state_from_numpy": lambda **kw: am_state_from_numpy(_am_arrays(), **kw).chol,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry):
    """No ``device=``: the tensors land on ``cuda``, or the call raises
    where CUDA is absent."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_on_the_cpu_when_asked(entry):
    assert ENTRY_POINTS[entry](device="cpu").device.type == "cpu"


def test_cpu_tensor_data_decides_the_device():
    """A problem over CPU data lives on the CPU, with no ``device=``."""
    problem = define_inference_problem(
        parameters=[("m", -3.0, 3.0)], data=torch.zeros(4, dtype=torch.float64),
        log_likelihood=lambda th, y: -0.5 * torch.sum((y - th[0]) ** 2), prior_distribution=["location"])
    assert problem.device.type == "cpu" and problem.data.device.type == "cpu"


@pytest.mark.parametrize("available", [True, False])
def test_resolve_device_never_falls_back(available, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    assert resolve_device("cpu") == torch.device("cpu")
    if available:
        assert resolve_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
