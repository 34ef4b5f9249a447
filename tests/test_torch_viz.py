"""The port's plots (``viz/plots.py``) against the JAX package's, on the CPU.

Each of the twelve functions draws, on the port's objects carried over from
the JAX package's (``interop``), the same data that the JAX function draws
on the originals: every line's x and y data, every bar's and histogram
bin's rectangle, every image and mesh array, every scatter's offsets and
sizes, every filled band's vertices (1e-12), and the same titles and axis
labels.  The render test is ``tests/test_viz.py``'s: each figure makes a
PNG above 1000 bytes.
"""

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

from bayesianinference_tpu import dists as jd  # noqa: E402
from bayesianinference_tpu import viz as jviz  # noqa: E402
from bayesianinference_tpu.dists.pointwise import PointwiseMixture as JPointwise  # noqa: E402
from bayesianinference_tpu.results import regression_predictive_distribution  # noqa: E402
from bayesianinference_tpu.results.sbc import SBCResult as JSBCResult  # noqa: E402
from bayesianinference_tpu_torch import dists as td  # noqa: E402
from bayesianinference_tpu_torch import interop  # noqa: E402
from bayesianinference_tpu_torch import viz as tviz  # noqa: E402

torch.set_num_threads(1)


def _collection_data(c):
    out = []
    if hasattr(c, "_offsets3d"):
        out += [np.asarray(a, float) for a in c._offsets3d]
    elif c.get_offsets() is not None and len(c.get_offsets()):
        out.append(np.asarray(c.get_offsets(), float))
    if c.get_array() is not None:
        out.append(np.asarray(c.get_array(), float))
    if hasattr(c, "get_sizes") and len(c.get_sizes()):
        out.append(np.asarray(c.get_sizes(), float))
    if not out:  # a filled band: its outline
        out += [np.asarray(p.vertices, float) for p in c.get_paths()]
    return out


def drawn(fig) -> list:
    """What a figure draws, axes by axes: texts and numeric data."""
    axes = []
    for ax in fig.axes:
        texts = [ax.get_title(), ax.get_xlabel(), ax.get_ylabel()]
        data = [np.asarray(a, float) for line in ax.get_lines() for a in (line.get_xdata(), line.get_ydata())]
        data += [np.asarray(r.get_bbox().get_points(), float) for r in ax.patches if isinstance(r, Rectangle)]
        data += [np.asarray(im.get_array(), float) for im in ax.get_images()]
        data += [a for c in ax.collections for a in _collection_data(c)]
        axes.append((texts, data))
    suptitle = fig._suptitle.get_text() if fig._suptitle is not None else None
    return [suptitle, axes]


def same_drawing(got_fig, want_fig, rtol=1e-12):
    got, want = drawn(got_fig), drawn(want_fig)
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    for (g_texts, g_data), (w_texts, w_data) in zip(got[1], want[1]):
        assert g_texts == w_texts
        assert len(g_data) == len(w_data) and len(w_data) > 0 or not g_data
        for g, w in zip(g_data, w_data):
            assert g.shape == w.shape
            scale = np.nanmax(np.abs(w)) if w.size and np.isfinite(w).any() else 0.0
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale)
    plt.close(got_fig)
    plt.close(want_fig)


@pytest.fixture(scope="module")
def results(regression_ns):
    """The shared regression NS run (tests/conftest.py) and its port."""
    problem, res, x, y = regression_ns
    return res, interop.nested_sampling_result_from_numpy(res, device="cpu"), x, y


NS_PLOTS = [
    ("covariance_matrix_plot", ()),
    ("posterior_marginal_pdf_plot_1d", (0,)),
    ("posterior_marginal_pdf_plot_1d", (2,)),
    ("posterior_marginal_cdf_plot_1d", (1,)),
    ("posterior_marginal_pdf_density_plot_2d", ((0, 1),)),
    ("posterior_marginal_cdf_density_plot_2d", ((0, 2), 20)),
    ("posterior_bubble_chart", ((0, 1),)),
    ("posterior_bubble_chart", ((0, 1, 2),)),
    ("calculation_report_plot", ()),
]


@pytest.mark.parametrize("name, args", NS_PLOTS, ids=[f"{n}{a[:1]}" for n, a in NS_PLOTS])
def test_result_plots_draw_what_jax_draws(results, name, args):
    res, port_res, _, _ = results
    same_drawing(getattr(tviz, name)(port_res, *args), getattr(jviz, name)(res, *args))


def _predictives(res, port_res):
    xq = jnp.linspace(-2, 2, 15)
    want = regression_predictive_distribution(res, lambda th, xx: jd.Normal(th[0] * xx[:, 0] + th[1], th[2]),
                                              xq[:, None])
    return np.asarray(xq), want, interop.pointwise_mixture_from_numpy(want, device="cpu")


@pytest.mark.parametrize("moments", [False, True], ids=["percentiles", "moments"])
def test_regression_plot_draws_what_jax_draws(results, moments):
    res, port_res, x, y = results
    xq, want, got = _predictives(res, port_res)
    same_drawing(tviz.regression_plot_1d(port_res, got, torch.as_tensor(xq), x_data=np.asarray(x),
                                         y_data=np.asarray(y), moments=moments),
                 jviz.regression_plot_1d(res, want, xq, x_data=x, y_data=y, moments=moments))


def test_trace_plot_draws_what_jax_draws():
    chains = np.random.default_rng(0).normal(size=(3, 400, 2))
    fig = tviz.trace_plot(torch.as_tensor(chains), param_names=("a", "b"))
    assert len(fig.axes) == 4 and any("ESS" in ax.get_title() and "R-hat" in ax.get_title() for ax in fig.axes)
    same_drawing(fig, jviz.trace_plot(chains, param_names=("a", "b")))


def test_smc_report_plot_draws_what_jax_draws():
    from bayesianinference_tpu.engines import smc_sampler
    from bayesianinference_tpu.models import define_inference_problem

    problem = define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                       log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
                                       prior_distribution=["location", "location"], validate=False)
    want = smc_sampler(problem, jax.random.PRNGKey(0), n_particles=120, num_runs=3, mcmc_steps=5)
    got = interop.smc_result_from_numpy(want, device="cpu")
    fig = tviz.smc_report_plot(got)
    assert len(fig.axes) == 3
    same_drawing(fig, jviz.smc_report_plot(want))


def test_sbc_rank_plot_draws_what_jax_draws():
    ranks = np.random.default_rng(1).integers(0, 50, size=(120, 4))
    want = JSBCResult(ranks=jnp.asarray(ranks, jnp.int32), thetas=jnp.zeros((120, 4)), num_draws=49,
                      param_names=("a", "b", "c", "d"))
    got = interop.sbc_result_from_numpy(want, device="cpu")
    for bins in (0, 7):
        same_drawing(tviz.sbc_rank_plot(got, num_bins=bins), jviz.sbc_rank_plot(want, num_bins=bins))


def test_calibration_plot_draws_what_jax_draws():
    rng = np.random.default_rng(0)
    m = 300
    mu, s = rng.normal(size=m), rng.uniform(0.5, 1.5, size=m)
    y = rng.normal(mu, s)
    want = JPointwise(log_weights=jnp.zeros(1), component=jd.Normal(jnp.asarray(mu)[None], jnp.asarray(s)[None]))
    got = td.PointwiseMixture(log_weights=torch.zeros(1, dtype=torch.float64),
                              component=td.Normal(torch.as_tensor(mu)[None], torch.as_tensor(s)[None]))
    fig = tviz.calibration_plot(got, torch.as_tensor(y))
    assert len(fig.axes) == 3
    same_drawing(fig, jviz.calibration_plot(want, jnp.asarray(y)))


def test_all_plots_render(results, tmp_path):
    res, port_res, x, y = results
    xq, _, pred = _predictives(res, port_res)
    figs = {
        "cov": tviz.covariance_matrix_plot(port_res),
        "pdf1d": tviz.posterior_marginal_pdf_plot_1d(port_res, 0),
        "cdf1d": tviz.posterior_marginal_cdf_plot_1d(port_res, 0),
        "pdf2d": tviz.posterior_marginal_pdf_density_plot_2d(port_res, (0, 1)),
        "cdf2d": tviz.posterior_marginal_cdf_density_plot_2d(port_res, (0, 1), num_points=20),
        "bubble": tviz.posterior_bubble_chart(port_res, (0, 1)),
        "bubble3d": tviz.posterior_bubble_chart(port_res, (0, 1, 2)),
        "report": tviz.calculation_report_plot(port_res),
        "regression": tviz.regression_plot_1d(port_res, pred, xq, x_data=np.asarray(x), y_data=np.asarray(y)),
        "regression_moments": tviz.regression_plot_1d(port_res, pred, xq, x_data=np.asarray(x),
                                                      y_data=np.asarray(y), moments=True),
        "trace": tviz.trace_plot(np.random.default_rng(0).normal(size=(3, 200, 2))),
    }
    for name, fig in figs.items():
        out = tmp_path / f"{name}.png"
        fig.savefig(out, dpi=50)
        assert out.stat().st_size > 1000, name
    plt.close("all")


def test_viz_imports_without_drawing(monkeypatch):
    """Importing the port's viz needs no matplotlib: it is imported when a
    function draws.  A fresh import of the package's viz modules, with
    matplotlib blocked."""
    import importlib
    import sys

    import bayesianinference_tpu_torch as bi

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for name in [m for m in sys.modules if m.startswith("bayesianinference_tpu_torch.viz")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.delattr(bi, "viz", raising=False)
    viz = importlib.import_module("bayesianinference_tpu_torch.viz")
    assert viz is not tviz and callable(viz.trace_plot)
    with pytest.raises(ImportError):
        viz.trace_plot(np.random.default_rng(0).normal(size=(2, 50)))
