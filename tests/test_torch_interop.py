"""The port's entry points put new state on the CUDA card unless the caller
asks for the CPU, and raise where there is no card (no fallback to the
host).  Each test decides inside itself whether a card is present."""

import numpy as np
import pytest
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process, predict_from_gaussian_process
from bayesianinference_tpu_torch.interop import am_state_from_numpy, ns_state_from_numpy, problem_data_from_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel


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


_GP_X = np.linspace(0.0, 1.0, 12).reshape(6, 2)
_GP_Y = np.sin(_GP_X[:, 0])
_GP_PARAMS = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]


def _gp(x, y, **kw):
    return define_gaussian_process(x, y, lambda th: se_kernel(th[0] ** 2, th[1]), _GP_PARAMS,
                                   nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3, **kw)


def _neg_square(th):
    return -0.5 * torch.sum(th**2)


# each entry point called without tensor data; returns one tensor it made
ENTRY_POINTS = {
    "define_gaussian_process[numpy]": lambda **kw: _gp(_GP_X, _GP_Y, **kw).metadata["gaussian_process"].x,
    "define_gaussian_process[lists]": lambda **kw: _gp(_GP_X.tolist(), _GP_Y.tolist(), **kw).lower,
    "laplace_posterior_fit[list bounds]": lambda **kw: tl.laplace_posterior_fit(
        log_likelihood=_neg_square, log_prior=lambda th: 0.0 * th[0], lower=[-2.0, -2.0], upper=[2.0, 2.0],
        num_starts=2, **kw).mean,
    "laplace_posterior_fit[list starts]": lambda **kw: tl.laplace_posterior_fit(
        log_likelihood=_neg_square, log_prior=lambda th: 0.0 * th[0], initial_guess=[[0.5, -0.5]], **kw).mean,
    "find_mode[list starts]": lambda **kw: tl.find_mode(_neg_square, [[0.5, -0.5]], lower=[-2.0, -2.0],
                                                        upper=[2.0, 2.0], **kw)[0],
    "approximate_evidence[numpy starts]": lambda **kw: tl.approximate_evidence(
        _neg_square, np.array([[0.5, -0.5]]), **kw).mean,
    "approximate_evidence_hyper[list starts]": lambda **kw: tl.approximate_evidence_hyper(
        lambda eta: (lambda th: -0.5 * torch.exp(eta[0]) * torch.sum(th**2)), [[0.5]], n_hyper=1,
        max_hyper_iterations=2, **kw).mean,
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


class _Samples:
    """A plain (points, log_weights) result, not a NestedSamplingResult."""

    def __init__(self, points, log_weights):
        self.points, self.log_weights = points, log_weights


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_predict_puts_plain_samples_on_the_models_device_and_dtype(dtype):
    """Lists, numpy arrays and tensors of another dtype give the same
    predictive as tensors of the model's own dtype on its device
    (rtol 1e-12 in float64: no detour through the default dtype)."""
    problem = _gp(_GP_X, _GP_Y, device="cpu") if dtype == torch.float64 else _gp(
        torch.as_tensor(_GP_X, dtype=dtype), torch.as_tensor(_GP_Y, dtype=dtype))
    model = problem.metadata["gaussian_process"]
    assert model.x.dtype == dtype and model.y.dtype == dtype
    thetas, log_w = np.array([[1.0, 0.8, 0.1], [0.7, 1.3, 0.2]]), np.log([0.3, 0.7])
    query = np.array([[0.2, 0.3], [0.9, 0.1]])
    want = predict_from_gaussian_process(
        _Samples(torch.as_tensor(thetas, dtype=dtype), torch.as_tensor(log_w, dtype=dtype)), problem, query)
    for points, weights in ((thetas.tolist(), log_w.tolist()), (thetas, log_w), (thetas.astype(np.float32), None)):
        got = predict_from_gaussian_process(_Samples(points, weights), problem, query)
        assert got.log_weights.dtype == dtype and got.log_weights.device == model.x.device
        assert got.mean().dtype == dtype
        if weights is not None:
            np.testing.assert_allclose(got.mean().numpy(), want.mean().numpy(),
                                       rtol=1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
def test_predict_moves_cpu_samples_to_a_model_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = _gp(_GP_X, _GP_Y)
    got = predict_from_gaussian_process(_Samples([[1.0, 0.8, 0.1]], [0.0]), problem, [[0.2, 0.3]])
    assert got.mean().device.type == "cuda"
