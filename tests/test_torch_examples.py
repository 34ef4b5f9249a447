"""The port's examples (``examples_torch/``) against the JAX package's (``examples/``).

There is one port example for each JAX example, under the same number and
name.  None imports JAX or the JAX package, each honours ``BI_EXAMPLE_SMOKE``
and names its device through ``BI_EXAMPLE_DEVICE`` (the card when unset).
The data files that stand in for the JAX examples' own draws equal the live
JAX draws, the Iris table equals scikit-learn's, and the conjugate example's
per-degree evidences equal the JAX example's to 1e-10.

Slow: every port example at smoke size on the CPU passes its checks
(``examples_torch/gates.py``) and is held against the JAX example's run
(``PARITY``); and, marked ``cuda`` too, every port example at its own size on
the card (``BI_EXAMPLE_SMOKE`` unset).

``PYTHONPATH=. python tests/test_torch_examples.py`` rewrites the data files
that hold the JAX examples' draws (the suite's x64 CPU settings, from
``tests/conftest.py``); ``... --jax-headlines NN [NN ...]`` runs those JAX
examples whole under the same settings and prints their headline numbers,
one JSON line each."""

import ast
import glob
import json
import math
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "[0-9]*.py")))
PORT_EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples_torch", "[0-9]*.py")))
DATA = os.path.join(ROOT, "examples_torch", "data")
NUMBERS = [os.path.basename(p)[:2] for p in PORT_EXAMPLES]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bayesianinference_tpu")

sys.path.insert(0, os.path.join(ROOT, "examples_torch"))
import gates  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's examples on the CPU dispatch many small operations: one
    thread each keeps the suite's workers from oversubscribing the host."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _name(path):
    return os.path.basename(path)[:-3]


def test_one_port_example_for_each_jax_example():
    assert len(JAX_EXAMPLES) == 31
    assert [_name(p) for p in PORT_EXAMPLES] == [_name(p) for p in JAX_EXAMPLES]
    assert gates.NUMBERS == tuple(NUMBERS) and sorted(gates.CHECKS) == NUMBERS == sorted(gates.HEADLINES)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_EXAMPLES + [gates.__file__], ids=NUMBERS + ["gates"])
def test_port_example_imports_no_jax_and_reads_both_knobs(path):
    source = open(path).read()
    roots = {m.split(".")[0] for m in _imports(path)}
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    strings = {n.value for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not any("XLA_FLAGS" in s or "xla_force_host_platform_device_count" in s for s in strings)
    if path != gates.__file__:
        assert "BI_EXAMPLE_SMOKE" in strings and "BI_EXAMPLE_DEVICE" in strings
        assert "resolve_device" in source  # the card unless the variable names another device


def test_iris_table_equals_scikit_learns():
    datasets = pytest.importorskip("sklearn.datasets")
    table = np.loadtxt(os.path.join(DATA, "iris.csv"), delimiter=",", skiprows=1)
    iris = datasets.load_iris()
    np.testing.assert_array_equal(table[:, :4], iris.data)
    np.testing.assert_array_equal(table[:, 4].astype(int), iris.target)


def _jax_example_draws():
    """The draws of the JAX examples 18 (``kalman_sample`` under PRNGKey(3))
    and 25 (``hmm_sample_states`` under PRNGKey(4), at its smoke and full T)."""
    import jax
    import jax.numpy as jnp

    from bayesianinference_tpu.engines import seasonal_component, structural_lgssm, trend_component
    from bayesianinference_tpu.ops import HMM, hmm_sample_states, kalman_sample

    gen = structural_lgssm([trend_component(0.02, 1e-4), seasonal_component(7, 0.01)], obs_var=0.25)
    xs, ys = kalman_sample(jax.random.PRNGKey(3), gen, 300)
    hmm = HMM(initial_log_probs=jnp.log(jnp.asarray([0.5, 0.5])),
              transition_log_probs=jnp.log(jnp.asarray([[0.97, 0.03], [0.10, 0.90]])))
    states = {f"z{t}": np.asarray(hmm_sample_states(jax.random.PRNGKey(4), hmm, t)) for t in (120, 600)}
    return {"ssm_jax_draws.npz": {"xs": np.asarray(xs), "ys": np.asarray(ys)}, "hmm_jax_states.npz": states}


def test_data_files_hold_the_jax_examples_draws():
    for name, arrays in _jax_example_draws().items():
        with np.load(os.path.join(DATA, name)) as z:
            assert sorted(z.files) == sorted(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(z[k], v, err_msg=f"{name}:{k}")


def test_jax_serving_artifact_loads_bit_equal_in_both_packages():
    """``data/jax_serving_posterior.npz`` is the JAX example 10's ``save_result``
    (smoke size); the port loads it onto the CPU as the card run does onto the card."""
    from bayesianinference_tpu.engines import load_result as jax_load

    assert gates._jax_artifact_check("cpu").startswith("the JAX example's artifact loads onto cpu")
    res = jax_load(os.path.join(DATA, "jax_serving_posterior.npz"))
    with np.load(os.path.join(DATA, "jax_serving_posterior.npz")) as z:
        np.testing.assert_array_equal(np.asarray(res.log_evidence.mean), z["log_evidence.mean"])
    assert res.total_samples > 0


def test_port_example_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run there")
    monkeypatch.delenv("BI_EXAMPLE_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(gates.path_of("02"), run_name="__main__")


def _run_jax(number, monkeypatch, tmp_path):
    (path,) = glob.glob(os.path.join(ROOT, "examples", f"{number}_*.py"))
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    sub = tmp_path / "jax"
    sub.mkdir()
    monkeypatch.chdir(sub)
    return runpy.run_path(path, run_name="__main__")


def _run_port(number, monkeypatch):
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    monkeypatch.setenv("BI_EXAMPLE_DEVICE", "cpu")
    return gates.run_example(number)


def test_blr_example_matches_the_jax_example(monkeypatch, tmp_path):
    want = _run_jax("02", monkeypatch, tmp_path)
    got = _run_port("02", monkeypatch)
    for degree in range(5):
        a, b = float(got["results"][degree].log_evidence), float(want["results"][degree].log_evidence)
        assert abs(a - b) <= 1e-10 * abs(b), (degree, a, b)
    assert got["best"] == want["best"] == 2
    np.testing.assert_allclose(gates.arr(got["res"].posterior_parameters.b),
                               np.asarray(want["res"].posterior_parameters.b), rtol=1e-10)


# ---------------------------------------------------------------- slow: all 31 against JAX

# key of HEADLINES -> (kind, tolerance): "rel" and "abs" for deterministic or
# closely comparable numbers, "sigma" for (mean, standard error) pairs held
# within that many joint standard errors, "equal" for exact agreement
PARITY = {
    "01": {"logZ": ("sigma", 4), "analytic": ("rel", 1e-12)},
    "02": {"logZ": ("rel", 1e-10), "best": ("equal", None), "coefficients": ("rel", 1e-10)},
    "03": {"logZ": ("sigma", 4), "mean": ("abs", 0.15)},
    "04": {"mode": ("abs", 1e-5), "logZ": ("rel", 1e-6)},
    "05": {"logZ": ("sigma", 4), "mean": ("abs", 0.02)},
    "06": {"combined logZ": ("sigma", 4), "checkpointed logZ": ("sigma", 4)},
    "07": {"loss": ("abs", 0.5)},
    "08": {"mode": ("abs", 1e-5), "logZ": ("rel", 1e-6)},
    "09": {"pool logZ": ("sigma", 4), "sharded logML": ("rel", 1e-10), "dense logML": ("rel", 1e-10),
           "BLR logZ": ("rel", 1e-10)},
    "10": {"logZ": ("sigma", 4), "last mu_hat": ("abs", 0.125), "last truth": ("rel", 1e-12)},
    "11": {"logZ": ("sigma", 4), "mean": ("abs", 0.1)},
    "12": {"NS logZ": ("sigma", 4), "SMC logZ": ("sigma", 4), "HMC mean": ("abs", 0.05)},
    "13": {"Normal logZ": ("sigma", 4), "StudentT logZ": ("sigma", 4), "stacking": ("abs", 0.1)},
    "14": {"Laplace logZ": ("rel", 1e-6), "Pathfinder ELBO": ("abs", 0.3), "IS logZ": ("abs", 0.3)},
    "15": {},
    "16": {"static logZ": ("sigma", 4), "dynamic logZ": ("sigma", 4), "static mean": ("abs", 0.05)},
    "17": {"mode": ("abs", 1e-4), "logZ": ("rel", 1e-6), "rmse": ("abs", 0.01)},
    # bimodal: JAX's starts reach the mode at level_var's lower bound (1e-6), the port's (seeds 0, 1, 4) an interior
    # one; each package's fit is printed, and the port's is held to its checks
    "18": {},
    "19": {"NS logZ": ("sigma", 4)},
    "20": {},
    "21": {"err": ("abs", 0.05), "acc": ("abs", 0.05)},
    "22": {"acc": ("abs", 0.05), "corr_sd": ("abs", 0.1)},
    "23": {},
    # four joint sd of the 512-particle IBIS logZ over seeds (0.89 and 0.50; tests/ibis_example_spread_study.py)
    "24": {"Gaussian": ("abs", 5.0), "Student-t3": ("abs", 2.8), "advantage": ("abs", 5.8)},
    "25": {"mode": ("abs", 1e-4), "logZ": ("rel", 1e-6), "viterbi": ("abs", 0.02)},
    "26": {"mode": ("abs", 1e-4), "logZ": ("rel", 1e-6), "found": ("equal", None)},
    "27": {"Laplace logZ": ("rel", 1e-6), "NS logZ": ("sigma", 4)},
    "28": {"rmse RBPF": ("abs", 0.3), "rmse obs": ("rel", 1e-12), "maneuver acc": ("abs", 0.1)},
    "29": {"CV best": ("abs", 0.1)},
    "30": {"collapsed logZ": ("rel", 1e-8), "exact logZ": ("rel", 1e-10), "NS logZ": ("sigma", 4),
           "E[mu], E[tau]": ("abs", 0.5)},
    "31": {"corr": ("abs", 0.05)},
}
# the Laplace fits of 19 and 20 compare field by field
NESTED = {"19": {"Laplace": {"mode": ("abs", 1e-5), "logZ": ("rel", 1e-6)},
                 "Poisson": {"mode": ("abs", 1e-5), "logZ": ("rel", 1e-6)}},
          "20": {"TP": {"mode": ("abs", 1e-4), "logZ": ("rel", 1e-6)},
                 "GP": {"mode": ("abs", 1e-4), "logZ": ("rel", 1e-6)}}}


def _agree(key, kind, tol, got, want):
    if kind == "sigma":
        (a, sa), (b, sb) = got, want
        assert abs(a - b) <= tol * math.hypot(sa, sb), (key, got, want)
    elif kind == "equal":
        assert got == want, (key, got, want)
    else:
        a, b = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
        bound = tol * np.maximum(np.abs(b), 1e-300) if kind == "rel" else tol
        assert np.all(np.abs(a - b) <= bound), (key, got, want)


@pytest.mark.slow
@pytest.mark.parametrize("number", NUMBERS)
def test_port_example_matches_jax_example(number, monkeypatch, tmp_path):
    want = gates.HEADLINES[number](_run_jax(number, monkeypatch, tmp_path))
    monkeypatch.setenv("BI_EXAMPLE_SMOKE", "1")
    monkeypatch.setenv("BI_EXAMPLE_DEVICE", "cpu")
    got = gates.run(number)
    print(json.dumps({"example": number, "port": got["headline"], "jax": want, "checks": got["checks"]}))
    for key, (kind, tol) in PARITY[number].items():
        _agree(key, kind, tol, got["headline"][key], want[key])
    for outer, fields in NESTED.get(number, {}).items():
        for key, (kind, tol) in fields.items():
            _agree(f"{outer} {key}", kind, tol, got["headline"][outer][key], want[outer][key])


# the JAX examples' headlines at their own sizes (``--jax-headlines``: x64 on the CPU), for the card run, where there
# is no JAX; 18's Laplace fit is deterministic, 23's PMMH draws are held within the JAX draws' spread
JAX_FULL_SIZE = {
    "18": {"mode": [1e-06, 0.00024180416267592265, 0.010049203274326563, 0.26942929386813247],
           "forecast": [1297.1616821763816, 2.1978781436112342]},
    "23": {"mean": [-1.0495906298725377, 0.9750252096710229, 0.1720312463530532],
           "sd": [0.4522241777029251, 0.01671553449716721, 0.05015012621678955]},
}
FULL_SIZE_PARITY = {"18": {"mode": ("abs", 1e-5), "forecast": ("rel", 1e-6)}}


def _full_size_agrees(number, got):
    want = JAX_FULL_SIZE.get(number, {})
    for key, (kind, tol) in FULL_SIZE_PARITY.get(number, {}).items():
        _agree(key, kind, tol, got[key], want[key])
    if number == "23":  # a posterior mean within one JAX posterior sd, an sd within a factor of 2 of JAX's
        mean, sd, jmean, jsd = (np.asarray(v) for v in (got["mean"], got["sd"], want["mean"], want["sd"]))
        assert np.all(np.abs(mean - jmean) <= jsd) and np.all((sd > jsd / 2) & (sd < 2 * jsd)), (got, want)


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.parametrize("number", NUMBERS)
def test_port_example_at_full_size_on_the_card(number):
    """``python examples_torch/gates.py NN`` at the example's own size, on the card, in a fresh process; 18 and 23
    also against the JAX examples' own full-size headlines (``JAX_FULL_SIZE``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = {k: v for k, v in os.environ.items() if k not in ("BI_EXAMPLE_SMOKE", "BI_EXAMPLE_DEVICE")}
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples_torch", "gates.py"), number], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(reading))
    assert not reading["smoke"] and reading["checks"]
    _full_size_agrees(number, reading["headline"])


def _jax_headlines(number):
    """One JSON line: the JAX example ``number`` run whole (its own sizes, unless ``BI_EXAMPLE_SMOKE=1``) in a fresh
    working directory, and its headline numbers as ``gates.HEADLINES`` reads them."""
    import tempfile
    import time

    (path,) = glob.glob(os.path.join(ROOT, "examples", f"{number}_*.py"))
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        t = time.perf_counter()
        g = runpy.run_path(path, run_name="__main__")
        print(json.dumps({"example": number, "seconds": time.perf_counter() - t,
                          "headline": gates.HEADLINES[number](g)}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (x64 on the CPU, as the suite runs the JAX examples)

    if sys.argv[1:2] == ["--jax-headlines"]:  # python tests/test_torch_examples.py --jax-headlines NN [NN ...]
        for n in sys.argv[2:]:
            _jax_headlines(n)
    else:
        for name, arrays in _jax_example_draws().items():
            np.savez(os.path.join(DATA, name), **arrays)
