"""The port's model graphs (``utils/graph.py``), generative-model front end
(``models/generative.py``) and ``laplace_posterior_fit(model=...)`` against
the JAX package, on the CPU, float64.

The logistic model is ``tests/test_laplace.py``'s (an intercept and four
weights under Normal(0, 10) priors, ``BernoulliLogits`` labels) on four
covariates and labels from a seeded numpy generator, as ``chip_smoke.py``
phase 15e draws them: the JAX test's Iris data come from scikit-learn,
which the card's machine lacks.  Tolerances:

* graphs: equal structures, orders and ancestor sets;
* the generative problem's densities against the JAX problem's and the
  hand-written callables: rtol 1e-12;
* ``laplace_posterior_fit(model=...)`` against ``problem=`` on the same
  problem: mean 1e-8, logZ rtol 1e-10 (the JAX test's gates); against the
  JAX fit from the same starts: the Laplace parity of
  ``tests/test_torch_laplace.py`` (mode rtol 1e-6, logZ atol 1e-6);
* the conjugate model through nested sampling (5 standard errors of the
  closed-form logZ) and HMC (posterior mean within 0.15), the JAX test's
  oracle, nested sampling at a shorter setting (below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.dists.combinators import ConditionalProduct as JConditionalProduct
from bayesianinference_tpu.engines import laplace as jl
from bayesianinference_tpu.models import generative_model_problem as j_generative
from bayesianinference_tpu.utils import graph as jgraph
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.dists.combinators import ConditionalProduct
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.models import generative_model_problem
from bayesianinference_tpu_torch.utils import dependency_data, model_graph

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def logistic_data(n: int, seed: int = 0):
    """Four standardized normal covariates and Bernoulli labels of
    sigmoid(0.5 + x @ [1.5, -2, 0.7, 0])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    x = (x - x.mean(0)) / x.std(0)
    p = 1.0 / (1.0 + np.exp(-(0.5 + x @ np.array([1.5, -2.0, 0.7, 0.0]))))
    return x, (rng.uniform(size=n) < p).astype(float)


PARAMS = [("b0", -50.0, 50.0), ("w", -50.0, 50.0, (4,))]


def _logistic_model(dists, cp, zeros):
    return cp([
        ("b0", lambda v: dists.Normal(0.0, 10.0)),
        ("w", lambda v: dists.Normal(zeros(4), 10.0)),
        ("y", lambda v: dists.BernoulliLogits(logits=v["b0"] + v["x"] @ v["w"])),
    ])


def _port_model():
    return _logistic_model(td, ConditionalProduct, lambda k: torch.zeros(k, dtype=torch.float64))


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------


def test_model_graph_matches_jax():
    kw = dict(edges=[("alpha", "w"), ("w", "y"), ("x", "y")], inputs=["x"], outputs=["y"])
    g, jg = model_graph(**kw), jgraph.model_graph(**kw)
    assert g == type(g)(*(getattr(jg, f) for f in ("vertices", "edges", "inputs", "outputs")))
    assert g.is_acyclic() and g.topological_order() == jg.topological_order()
    g.validate_dependencies()
    assert dependency_data(g) == jgraph.dependency_data(jg)
    assert dependency_data(g)["y"]["ancestors"] == frozenset({"alpha", "w", "x"})
    assert dependency_data(g)["alpha"]["descendants"] == frozenset({"w", "y"})
    assert g.parents("y") == ["w", "x"] and g.children("alpha") == ["w"]


def test_model_graph_rejects_cycles_and_bad_deps():
    g = model_graph(edges=[("a", "b"), ("b", "a")])
    assert not g.is_acyclic()
    with pytest.raises(ValueError, match="cyclic"):
        g.validate_dependencies()
    with pytest.raises(ValueError, match="cyclic"):
        g.topological_order()
    with pytest.raises(ValueError, match="independent"):
        model_graph(edges=[("w", "x")], inputs=["x"], outputs=["y"]).validate_dependencies()
    with pytest.raises(ValueError, match="cannot depend on dependent"):
        model_graph(edges=[("y", "w")], inputs=[], outputs=["y"]).validate_dependencies()


def test_conditional_product_graph_matches_jax():
    """The edges traced from the builders are the JAX package's."""
    jmodel = _logistic_model(jd, JConditionalProduct, jnp.zeros)
    assert sorted(_port_model().graph()) == sorted(jmodel.graph())


# ---------------------------------------------------------------------------
# the generative problem and the Laplace front end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logistic():
    x, y = logistic_data(200)
    problem = generative_model_problem(_port_model(), data={"y": T(y)}, parameters=PARAMS, inputs={"x": T(x)})
    jproblem = j_generative(_logistic_model(jd, JConditionalProduct, jnp.zeros), data={"y": jnp.asarray(y)},
                            parameters=PARAMS, inputs={"x": jnp.asarray(x)})
    return x, y, problem, jproblem


def test_generative_problem_matches_jax_and_callables(logistic):
    x, y, problem, jproblem = logistic
    assert problem.param_names == jproblem.param_names == ("b0", "w[0]", "w[1]", "w[2]", "w[3]")
    close(problem.lower, jproblem.lower, rtol=0)
    close(problem.upper, jproblem.upper, rtol=0)
    assert problem.device.type == "cpu" and problem.dtype == torch.float64
    thetas = np.array([[0.3, -1.0, 0.5, 2.0, -0.7], [0.0, 0.1, 0.2, -0.3, 0.4], [1.0, 1.5, -2.0, 0.7, 0.0]])
    close(problem.raw_log_likelihood(T(thetas)), [float(jproblem.log_likelihood(jnp.asarray(t))) for t in thetas],
          rtol=1e-12)
    for th in thetas:
        want_ll = torch.sum(td.BernoulliLogits(logits=th[0] + T(x) @ T(th[1:])).log_prob(T(y)))
        close(problem.log_likelihood(T(th)), want_ll, rtol=1e-12)
        close(problem.log_prior(T(th)), float(jproblem.log_prior(jnp.asarray(th))), rtol=1e-12)
        close(problem.log_prior(T(th)), torch.sum(td.Normal(0.0, 10.0).log_prob(T(th))), rtol=1e-12)
    graph = problem.metadata["model_graph"]
    assert graph.inputs == ("x",) and graph.outputs == ("y",)


def test_laplace_model_front_end_matches_problem_and_jax(logistic):
    """``model=`` reproduces ``problem=`` on the same problem (the JAX
    test's gates), and both the JAX fit from the same starts."""
    x, y, problem, jproblem = logistic
    fit = tl.laplace_posterior_fit(model=_port_model(), data={"y": T(y)}, parameters=PARAMS,
                                   model_inputs={"x": T(x)}, generator=torch.Generator().manual_seed(0))
    ref = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    close(fit.mean, ref.mean, rtol=0, atol=1e-8)
    close(fit.log_evidence, ref.log_evidence, rtol=1e-10)
    assert fit.param_names == problem.param_names
    starts = np.array([[0.0] * 5, [1.0, -1.0, 2.0, -3.0, -2.0], [-2.0, 0.5, 0.5, 0.5, 0.5]])
    got = tl.laplace_posterior_fit(model=_port_model(), data={"y": T(y)}, parameters=PARAMS,
                                   model_inputs={"x": T(x)}, initial_guess=T(starts))
    want = jl.laplace_posterior_fit(problem=jproblem, initial_guess=jnp.asarray(starts))
    close(got.mean, want.mean, rtol=1e-6, atol=1e-8)
    close(got.log_evidence, want.log_evidence, rtol=0, atol=1e-6)
    close(got.mean, fit.mean, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="either model"):
        tl.laplace_posterior_fit(model=_port_model(), problem=problem)


def test_generative_model_validation_errors():
    """The structural checks of LA:485-504 reject bad models."""
    bad = ConditionalProduct([("y", lambda v: td.Normal(0.0, 1.0)), ("mu", lambda v: td.Normal(v["y"], 1.0))])
    with pytest.raises(ValueError, match="cannot depend on dependent"):
        generative_model_problem(bad, data={"y": T([0.1])}, parameters=["mu"])
    bad2 = ConditionalProduct([
        ("mu", lambda v: td.Normal(0.0, 1.0)),
        ("x", lambda v: td.Normal(v["mu"], 1.0)),
        ("y", lambda v: td.Normal(v["x"], 1.0)),
    ])
    with pytest.raises(ValueError, match="independent variable"):
        generative_model_problem(bad2, data={"y": T([0.1])}, parameters=["mu"], inputs={"x": T([0.0])})
    with pytest.raises(ValueError, match="neither observed"):
        generative_model_problem(bad2, data={"y": T([0.1])}, parameters=["mu"])
    with pytest.raises(ValueError, match="not a model node"):
        generative_model_problem(bad2, data={"z": T([0.1])}, parameters=["mu"])
    with pytest.raises(ValueError, match="both observed and free"):
        generative_model_problem(bad2, data={"y": T([0.1])}, parameters=["mu", "y"], inputs={"x": T([0.0])})
    with pytest.raises(ValueError, match="duplicate"):
        generative_model_problem(bad2, data={"y": T([0.1])}, parameters=["mu", "mu"], inputs={"x": T([0.0])})


def test_generative_model_input_as_node_and_device():
    """An input that is also a model node (its density ignored, its value
    given); data that are not tensors go to ``device``, the card by
    default."""
    model = ConditionalProduct([
        ("x", lambda v: td.Normal(0.0, 1.0)),
        ("mu", lambda v: td.Normal(0.0, 2.0)),
        ("y", lambda v: td.Normal(v["mu"] + v["x"], 1.0)),
    ])
    xval, yval = np.array([0.3, -0.2]), np.array([1.0, 0.5])
    problem = generative_model_problem(model, data={"y": yval}, parameters=[("mu", -9.0, 9.0)], inputs={"x": xval},
                                       device="cpu")
    th = T([0.7])
    close(problem.log_likelihood(th), torch.sum(td.Normal(0.7 + T(xval), 1.0).log_prob(T(yval))), rtol=1e-12)
    close(problem.log_prior(th), td.Normal(0.0, 2.0).log_prob(T(0.7)), rtol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generative_model_problem(model, data={"y": yval}, parameters=[("mu", -9.0, 9.0)], inputs={"x": xval})


def test_generative_problem_is_engine_agnostic():
    """The generative problem is a plain InferenceProblem: nested sampling
    and HMC consume it, against the conjugate closed form."""
    from bayesianinference_tpu_torch.engines import hmc_sample
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    rng = np.random.default_rng(2)
    scale, prior_scale, n = 1.0, 3.0, 20
    y = rng.normal(0.7, scale, size=n)
    model = ConditionalProduct([("mu", lambda v: td.Normal(0.0, prior_scale)),
                                ("y", lambda v: td.Normal(v["mu"], scale))])
    problem = generative_model_problem(model, data={"y": T(y)}, parameters=[("mu", -12.0, 12.0)])
    exact = st.multivariate_normal(np.zeros(n), scale**2 * np.eye(n) + prior_scale**2).logpdf(y)
    # the JAX test's pool of 150, but the live points start at prior draws
    # and the run deletes 10 per iteration with 25-step chains: seeding by
    # MCMC (the path of a problem without a prior distribution) and the
    # default run take 155 s and about 100 s of eager density calls on the CPU
    g = torch.Generator().manual_seed(0)
    start = td.Truncated(td.Normal(0.0, prior_scale), low=-12.0, high=12.0).sample(g, (150,))[:, None]
    res = nested_sampling(problem, g, sample_pool_size=150, starting_points=start.double(), num_delete=10,
                          monte_carlo_steps=25)
    zerr = max(float(res.log_evidence.standard_error), 1e-3)
    assert abs(float(res.log_evidence.mean) - exact) < 5 * zerr
    prec_post = 1.0 / prior_scale**2 + n / scale**2
    hmc = hmc_sample(problem, torch.Generator().manual_seed(0), num_chains=4, num_samples=200, num_warmup=120,
                     num_leapfrog=8)
    mu_hat = float(hmc.posterior_samples().mean()[0])
    assert abs(mu_hat - float(np.sum(y) / scale**2 / prec_post)) < 0.15
