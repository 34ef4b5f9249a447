"""The checks of the port's examples and their headline numbers, in one table.

``run(number)`` runs ``examples_torch/<number>_*.py`` with ``runpy`` in a
fresh working directory, counts the launches of the two hand-written CUDA
kernels (the wrappers' own counters), reads the card's peak memory, and
holds the example's results to its checks.  ``python examples_torch/gates.py
NN [NN ...]`` does that for each example named and prints one JSON line
each; it exits non-zero at the first failed check.  ``BI_EXAMPLE_SMOKE`` and
``BI_EXAMPLE_DEVICE`` reach the examples unchanged.

Each check is one of:

* an analytic oracle (a closed-form or quadrature evidence within 3 or 4
  of the run's standard errors, a conjugate evidence);
* the truth inside a credible band, for the examples that simulate data
  (the bands are wide at smoke size, where the runs are short);
* for the deterministic fits (``CPU_TWIN``), the same example run again on
  CPU tensors in the same process: Laplace modes within 1e-4 and log
  evidences within 1e-6 relative (the card and the CPU draw different
  starting points), conjugate evidences within 1e-10 relative.

``HEADLINES[number](globals)`` reads the numbers that the JAX example
prints from the globals of either package's run (torch tensors, numpy or
JAX arrays), so the tests can hold the two packages' runs side by side.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import runpy
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = tuple(os.path.basename(p)[:2] for p in sorted(glob.glob(os.path.join(HERE, "[0-9][0-9]_*.py"))))
# deterministic fits whose example also runs on CPU tensors in the gate's process (seconds on a CPU core)
CPU_TWIN = ("02", "04", "08", "17", "20")


def path_of(number: str) -> str:
    (path,) = glob.glob(os.path.join(HERE, f"{number}_*.py"))
    return path


def arr(x) -> np.ndarray:
    """A torch tensor, a JAX or numpy array, or a number as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def num(x) -> float:
    return float(arr(x).reshape(()))


def mean_err(me) -> tuple:
    """(mean, standard error) of a MeanAndError of either package."""
    return num(me.mean), num(me.standard_error)


def ns_moments(result) -> tuple:
    """Posterior mean and sd of a nested-sampling result from its crude weights."""
    w = np.exp(arr(result.crude_log_posterior_weights))
    w = w / w.sum()
    pts = arr(result.points)
    mean = w @ pts
    return mean, np.sqrt(w @ (pts - mean) ** 2)


def check(ok: bool, what: str) -> str:
    if not ok:
        raise AssertionError(what)
    return what


def within_sigma(name, got, err, want, k=3.0, floor=0.0) -> str:
    tol = k * err + floor
    return check(abs(got - want) <= tol, f"{name} {got:.6g} within {tol:.3g} of {want:.6g}")


def close(name, got, want, rtol=0.0, atol=0.0) -> str:
    got, want = arr(got), arr(want)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    tol = atol + rtol * float(np.max(np.abs(want))) if want.size else atol
    return check(gap <= tol and np.all(np.isfinite(got)), f"{name} {gap:.3g} from the reference (tolerance {tol:.3g})")


def box_gaussian_log_z(half_width: float, dim: int) -> float:
    """log of the integral of a standard normal density over [-a, a]^d under the uniform prior on the box."""
    mass = math.erf(half_width / math.sqrt(2.0))
    return dim * (math.log(mass) - math.log(2 * half_width))


def normal_log_z_quadrature(y) -> float:
    """log Z of example 11: N(mu, exp(log_sigma)) data under uniform priors on
    mu in [-5, 5] and log sigma in [-2, 2]; the mu integral in closed form
    (its tails past the box are below double precision here), log sigma by
    400-point Gauss-Legendre (as ``chip_smoke.py``'s multi-axis oracle)."""
    y = np.asarray(y, dtype=np.float64)
    xb, wb = np.polynomial.legendre.leggauss(400)
    ls, wls = 2.0 * xb, 2.0 * wb
    sig2 = np.exp(2.0 * ls)
    n = y.shape[0]
    inner = (-0.5 * (n - 1) * np.log(2 * np.pi * sig2) - 0.5 * np.sum((y - y.mean()) ** 2) / sig2 - 0.5 * np.log(n))
    top = inner.max()
    return float(top + np.log(np.sum(wls * np.exp(inner - top))) - np.log(10.0) - np.log(4.0))


def banana_log_z() -> float:
    """log Z of example 27's banana under the uniform prior on [-6, 6] x [-4, 12]: the b integral in closed form, a by
    the trapezoid rule on 2000 nodes."""
    a = np.linspace(-6.0, 6.0, 2000)
    s = 0.5  # b - a^2 / 2 ~ N(0, 0.5^2)
    lo, hi = (-4.0 - a**2 / 2) / s, (12.0 - a**2 / 2) / s
    phi = 0.5 * (np.vectorize(math.erf)(hi / math.sqrt(2)) - np.vectorize(math.erf)(lo / math.sqrt(2)))
    inner = np.exp(-a**2 / 8.0) * s * math.sqrt(2 * math.pi) * phi
    return float(np.log(np.trapezoid(inner, a)) - np.log(12.0 * 16.0))


# ---------------------------------------------------------------- headlines

def _fit(g, name="fit"):
    f = g[name]
    return {"mode": arr(f.mean).tolist(), "logZ": num(f.log_evidence)}


HEADLINES = {
    "01": lambda g: {"logZ": mean_err(g["result"].log_evidence), "analytic": float(g["analytic"]),
                     "mean": arr(g["result"].parameter_expected_values.mean).tolist()},
    "02": lambda g: {"logZ": [num(g["results"][k].log_evidence) for k in range(5)], "best": int(g["best"]),
                     "coefficients": arr(g["res"].posterior_parameters.b).tolist()},
    "03": lambda g: {"logZ": mean_err(g["result"].log_evidence),
                     "mean": arr(g["result"].parameter_expected_values.mean).tolist()},
    "04": lambda g: _fit(g),
    "05": lambda g: {"logZ": mean_err(g["result"].log_evidence), "mean": arr(g["est"]).tolist()},
    "06": lambda g: {"combined logZ": mean_err(g["result"].log_evidence),
                     "checkpointed logZ": mean_err(g["res"].log_evidence)},
    "07": lambda g: {"loss": [num(g["history"][0]), num(g["history"][-1])], "log evidence": num(g["lz"])},
    "08": lambda g: _fit(g),
    "09": lambda g: {"pool logZ": mean_err(g["result"].log_evidence), "sharded logML": float(g["sharded"]),
                     "dense logML": float(g["dense"]), "BLR logZ": num(g["blr_sh"].log_evidence)},
    "10": lambda g: {"logZ": mean_err(g["result"].log_evidence), "last mu_hat": float(g["mu_hat"]),
                     "last truth": float(g["true_mu"])},
    "11": lambda g: {"logZ": mean_err(g["result"].log_evidence),
                     "mean": arr(g["result"].parameter_expected_values.mean).tolist()},
    "12": lambda g: {"NS logZ": mean_err(g["ns"].log_evidence), "SMC logZ": mean_err(g["smc"].log_evidence),
                     "HMC mean": arr(g["hmc_mean"]).tolist()},
    "13": lambda g: {"Normal logZ": mean_err(g["res_n"].log_evidence),
                     "StudentT logZ": mean_err(g["res_t"].log_evidence),
                     "stacking": arr(g["w_stack"]).tolist()},
    "14": lambda g: {"Laplace logZ": num(g["lap"].log_evidence), "Pathfinder ELBO": num(g["pf"].elbo),
                     "IS logZ": num(g["pf"].log_evidence_is), "ADVI ELBO": num(g["vi"].elbo),
                     "mean": arr(g["mean"]).tolist()},
    # the JAX example keeps only the last study's p-values (the overconfident one's)
    "15": lambda g: {"overconfident": arr(g["p"]).tolist()}
                    | {label: arr(p).tolist() for label, p in g.get("pvalues", {}).items()},
    "16": lambda g: {"static logZ": mean_err(g["static"].log_evidence),
                     "dynamic logZ": mean_err(g["dynamic"].log_evidence),
                     "static mean": arr(g["ms"]).tolist()},
    "17": lambda g: {**_fit(g), "rmse": float(g["rmse"])},
    "18": lambda g: {**_fit(g), "forecast": [float(g["fmean"][-1]), float(g["fsd"][-1])]},
    "19": lambda g: {"Laplace": _fit(g), "NS logZ": mean_err(g["res"].log_evidence),
                     "Poisson": _fit(g, "count_fit")},
    "20": lambda g: {"TP": _fit(g, "tp_fit"), "GP": _fit(g, "gp_fit")},
    "21": lambda g: {"theta": arr(g["fit"].theta).tolist(), "ELBO": num(g["fit"].elbo), "err": float(g["err"]),
                     "acc": float(g["acc"])},
    "22": lambda g: {"acc": float(g["acc"]), "ELBO": num(g["fit"].elbo), "corr_sd": float(g["corr_sd"]),
                     "hetero ELBO": num(g["hfit"].elbo)},
    "23": lambda g: {"mean": arr(g["draws"]).mean(0).tolist(), "sd": arr(g["draws"]).std(0).tolist()},
    "24": lambda g: {name: num(r.log_evidence) for name, r in g["runs"].items()} | {"advantage": float(g["diff"][-1])},
    "25": lambda g: {**_fit(g), "viterbi": float(g["acc"])},
    "26": lambda g: {**_fit(g), "found": [int(k) for k in g["found"]]},
    "27": lambda g: {"Laplace logZ": num(g["la"].log_evidence), "ADVI ELBO": num(g["fr"].elbo),
                     "flow ELBO": num(g["fl"].elbo), "flow logZ": num(g["fl"].log_evidence),
                     "NS logZ": mean_err(g["ns"].log_evidence)},
    "28": lambda g: {"rmse RBPF": float(g["rmse_rbpf"]), "rmse obs": float(g["rmse_obs"]),
                     "rmse PF": float(g["rmse_pf"]), "maneuver acc": float(g["man_acc"])},
    "29": lambda g: {"camel best": num(g["res"].y_best), "CV best": num(g["y_best"])},
    "30": lambda g: {"collapsed logZ": num(g["post_c"].log_evidence), "exact logZ": num(g["post_e"].log_evidence),
                     "NS logZ": mean_err(g["ns"].log_evidence),
                     "E[mu], E[tau]": [float(arr(g["mu_s"]).mean()), float(arr(g["tau_s"]).mean())]},
    "31": lambda g: {"sd": arr(g["pooled"]).std(0).tolist(), "corr": float(np.corrcoef(arr(g["pooled"]).T)[0, 1]),
                     "AM sd": arr(g["am"]).std(0).tolist()},
}


# ---------------------------------------------------------------- checks

def _laplace_twin(name, g, cpu):
    a, b = g[name], cpu[name]
    return [close(f"{name} mode against CPU tensors", a.mean, b.mean, atol=1e-4),
            close(f"{name} log evidence against CPU tensors", a.log_evidence, b.log_evidence, rtol=1e-6)]


def _c01(g, smoke, cpu):
    lz, se = mean_err(g["result"].log_evidence)
    return [within_sigma("logZ", lz, se, g["analytic"])]


def _c02(g, smoke, cpu):
    out = [check(int(g["best"]) == 2, "best degree is 2")]
    for k in range(5):
        out.append(close(f"degree {k} logZ against CPU tensors", g["results"][k].log_evidence,
                         cpu["results"][k].log_evidence, rtol=1e-10))
    return out + [close("coefficients against the truth", g["res"].posterior_parameters.b, [0.5, -1.2, 0.8],
                        atol=0.15)]


def _c03(g, smoke, cpu):
    _, se = mean_err(g["result"].log_evidence)
    mean = arr(g["result"].parameter_expected_values.mean)
    xq = arr(g["xq"])[:, 0]
    inside = np.abs(xq) <= 3.0
    m, s = arr(g["pred"].mean())[inside], np.sqrt(arr(g["pred"].variance()))[inside]
    miss = np.abs(m - np.sin(1.5 * xq[inside]))
    return [check(np.isfinite(se) and 0.05 <= mean[2] <= 0.2, f"noise posterior mean {mean[2]:.4f} in [0.05, 0.2] "
                  "(true 0.1)"),
            check(bool(np.all(miss <= 3 * s)), f"predictive mean within 3 predictive sd of the truth at the "
                  f"{inside.sum()} plotted points in the data's range (worst {np.max(miss / s):.3f} sd)")]


def _c04(g, smoke, cpu):
    return _laplace_twin("fit", g, cpu) + [check(float(g["acc"]) == 1.0, "training accuracy 1.0 at the mode")]


def _c05(g, smoke, cpu):
    mean, sd = ns_moments(g["result"])
    return [within_sigma("mu", mean[0], sd[0], 0.3, k=4), within_sigma("sigma", mean[1], sd[1], 0.25, k=4)]


def _c06(g, smoke, cpu):
    want = box_gaussian_log_z(5.0, 2)
    lz, se = mean_err(g["result"].log_evidence)
    lz1, se1 = mean_err(g["res"].log_evidence)
    return [within_sigma("combined logZ", lz, se, want), within_sigma("checkpointed logZ", lz1, se1, want, k=4),
            check(int(g["ck"].state.n_dead) > 0, "the checkpoint holds dead points")]


def _c07(g, smoke, cpu):
    m, s = arr(g["pred"].mean()), arr(g["pred"].std())
    truth = np.sin(2 * arr(g["xq"])[:, 0])
    return [check(num(g["history"][-1]) < num(g["history"][0]), "the loss fell"),
            check(bool(np.all(np.abs(m - truth) <= 3 * s + 0.2)), "predictive means within 3 sd + 0.2 of the truth"),
            check(math.isfinite(num(g["lz"])), "finite network log evidence")]


def _c08(g, smoke, cpu):
    return _laplace_twin("fit", g, cpu) + [check(float(g["acc"]) > 0.8, f"mode accuracy {float(g['acc']):.3f} > 0.8")]


def _c09(g, smoke, cpu):
    lz, se = mean_err(g["result"].log_evidence)
    return [within_sigma("pool-sharded logZ", lz, se, box_gaussian_log_z(5.0, 2), k=4),
            close("sharded GP logML against the dense one", g["sharded"], g["dense"], rtol=1e-9),
            close("sharded predictive mean", g["mean_sh"], g["mean_ref"], atol=1e-8),
            close("sharded predictive sd", g["std_sh"], g["std_ref"], atol=1e-8),
            close("sharded BLR logZ", g["blr_sh"].log_evidence, g["blr_d"].log_evidence, rtol=1e-10),
            close("BLR coefficients against the truth", g["blr_sh"].posterior_parameters.b, [1.0, -2.0, 0.0, 0.5],
                  atol=0.01)]


def _jax_artifact_check(device) -> str:
    """The JAX example's ``save_result`` artifact (``data/jax_serving_posterior.npz``) loaded onto ``device`` by the
    port's ``load_result``: logZ and the posterior mean bit-equal to the file's numbers."""
    import torch

    from bayesianinference_tpu_torch.engines import load_result

    path = os.path.join(HERE, "data", "jax_serving_posterior.npz")
    res = load_result(path, device=device)
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    got_lz = res.log_evidence
    ok = (torch.as_tensor(got_lz.mean).device.type == torch.device(device).type
          and np.array_equal(arr(got_lz.mean), want["log_evidence.mean"])
          and np.array_equal(arr(got_lz.standard_error), want["log_evidence.standard_error"])
          and np.array_equal(arr(res.parameter_expected_values.mean), want["parameter_expected_values.mean"]))
    return check(ok, f"the JAX example's artifact loads onto {device}: logZ and posterior mean bit-equal to the file")


def _c10(g, smoke, cpu):
    out = [check(g["out"].returncode == 0 and "posterior-predictive quantiles" in g["out"].stdout,
                 "the fresh interpreter loaded the artifact and served quantiles")]
    for i, (m, t) in enumerate(zip(g["mu_hats"], g["true_mus"])):
        out.append(within_sigma(f"request {i} mu_hat", m, 1 / 8, t, k=4))
    return out + [_jax_artifact_check(g["DEVICE"])]


def _c11(g, smoke, cpu):
    lz, se = mean_err(g["result"].log_evidence)
    return [within_sigma("logZ against quadrature", lz, se, normal_log_z_quadrature(arr(g["data"])), k=4)]


def _c12(g, smoke, cpu):
    mean, _ = ns_moments(g["ns"])
    return [check(abs(g["delta"]) < 4 * g["joint"], f"NS against SMC {abs(g['delta']):.4f} < 4 joint sigma"),
            close("HMC posterior mean against NS", g["hmc_mean"], mean, atol=0.05)]


def _c13(g, smoke, cpu):
    bf, se = mean_err(g["bf"])
    return [check(bf > 0, f"log B(StudentT vs Normal) {bf:.2f} > 0"),
            check(float(arr(g["w_stack"])[1]) > 0.5, "stacking weight of StudentT > 0.5")]


def _c14(g, smoke, cpu):
    lap = num(g["lap"].log_evidence)
    return [check(num(g["pf"].elbo) <= lap + 0.1, "Pathfinder ELBO below the Laplace logZ"),
            check(num(g["vi"].elbo) <= lap + 0.1, "ADVI ELBO below the Laplace logZ"),
            check(abs(num(g["pf"].log_evidence_is) - lap) < 1.0, "Pathfinder IS logZ within 1 of Laplace")]


def _c15(g, smoke, cpu):
    exact, over = (arr(g["pvalues"][k]) for k in ("exact conjugate", "overconfident"))
    out = [check(float(exact.min()) > 1e-3, f"the exact pipeline's smallest p-value {exact.min():.4f} > 1e-3")]
    if not smoke:  # 20 replications cannot tell the shrunk posterior apart
        out.append(check(float(over.min()) < 0.01, f"the overconfident pipeline flagged (p {over.min():.2e})"))
    return out


def _c16(g, smoke, cpu):
    a, sa = mean_err(g["static"].log_evidence)
    b, sb = mean_err(g["dynamic"].log_evidence)
    return [within_sigma("dynamic logZ against static", b, math.hypot(sa, sb), a, k=4),
            close("posterior means", g["md"], g["ms"], atol=0.05)]


def _c17(g, smoke, cpu):
    return _laplace_twin("fit", g, cpu) + [check(float(g["rmse"]) < 0.1, f"predictive RMSE {float(g['rmse']):.4f}"
                                                 " < 0.1 (noise sd 0.1)")]


def _c18(g, smoke, cpu):
    mode = arr(g["fit"].mean)
    return [check(0.1 < mode[3] < 0.5, f"obs_var MAP {mode[3]:.4f} in (0.1, 0.5) (true 0.25)"),
            check(bool(np.all(np.isfinite(g["fsd"]))) and float(g["fsd"][-1]) > 0, "finite forecast band")]


def _c19(g, smoke, cpu):
    lz, se = mean_err(g["res"].log_evidence)
    p_map = arr(g["pred_map"].mean)
    p_true = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * arr(g["xq"])[:, 0])))
    return [within_sigma("NS logZ against Laplace", lz, se, num(g["fit"].log_evidence), k=4, floor=1.0),
            check(float(np.mean(np.abs(p_map - p_true))) < 0.2, "MAP class probabilities within 0.2 of the truth"),
            check(math.isfinite(num(g["count_fit"].log_evidence)), "finite Poisson evidence")]


def _c20(g, smoke, cpu):
    return (_laplace_twin("tp_fit", g, cpu) + _laplace_twin("gp_fit", g, cpu)
            + [check(num(g["tp_fit"].log_evidence) > num(g["gp_fit"].log_evidence), "the evidence prefers the TP")])


def _c21(g, smoke, cpu):
    return [check(float(g["acc"]) > 0.75, f"decision agreement {float(g['acc']):.3f} > 0.75"),
            check(float(g["err"]) < 0.2, f"mean |p - p_true| {float(g['err']):.3f} < 0.2")]


def _c22(g, smoke, cpu):
    return [check(float(g["acc"]) > 0.9, f"Iris accuracy {float(g['acc']):.3f} > 0.9"),
            check(float(g["corr_sd"]) > 0.6, f"noise-profile correlation {float(g['corr_sd']):.3f} > 0.6")]


def _c23(g, smoke, cpu):
    d = arr(g["draws"])
    out = [check(bool(np.all(np.isfinite(d))) and bool(np.all(np.isfinite(arr(g["pf"].filter_means)))),
                 "finite draws and filtered path")]
    if not smoke:  # 20 + 20 steps do not reach the posterior
        for i, t in enumerate(g["truths"]):
            out.append(within_sigma(g["names"][i], d[:, i].mean(), d[:, i].std(), t, k=4, floor=0.05))
    return out


def _c24(g, smoke, cpu):
    return [check(num(g["runs"]["Student-t3"].log_evidence) > num(g["runs"]["Gaussian"].log_evidence),
                  "Student-t3 evidence above the Gaussian's"),
            check(float(g["diff"][-1]) > 0, "positive prequential advantage")]


def _c25(g, smoke, cpu):
    return [check(float(g["acc"]) > 0.85, f"Viterbi accuracy {float(g['acc']):.3f} > 0.85")]


def _c26(g, smoke, cpu):
    hits = sum(any(abs(f - t) <= 5 for f in g["found"]) for t in g["true_cps"])
    return [check(hits >= 2, f"{hits} of the 3 changepoints found within 5 steps"),
            check(0.002 < float(g["h"]) < 0.05, f"hazard {float(g['h']):.4f} in (0.002, 0.05)")]


def _c27(g, smoke, cpu):
    want = banana_log_z()
    lz, se = mean_err(g["ns"].log_evidence)
    return [within_sigma("NS logZ against quadrature", lz, se, want, k=4),
            check(num(g["fr"].elbo) <= want + 0.05 and num(g["fl"].elbo) <= want + 0.05, "ELBOs below logZ")]


def _c28(g, smoke, cpu):
    return [check(float(g["rmse_rbpf"]) < float(g["rmse_obs"]), "RBPF beats the raw observations"),
            check(float(g["man_acc"]) >= 0.8, f"maneuver accuracy {float(g['man_acc']):.2f} >= 0.8")]


def _c29(g, smoke, cpu):
    y = arr(g["res"].y_history)
    out = [check(bool(np.isfinite(y).all()) and num(g["res"].y_best) <= y.min() + 1e-12, "best is the history's min"),
           check(math.isfinite(num(g["y_best"])), "finite CV loss")]
    if not smoke:
        out.append(check(num(g["res"].y_best) < -0.9, f"camel best {num(g['res'].y_best):.4f} < -0.9"))
    return out


def _c30(g, smoke, cpu):
    lz, se = mean_err(g["ns"].log_evidence)
    quad = num(g["post_c"].log_evidence)
    return [close("collapsed against exact quadrature logZ", g["post_c"].log_evidence, g["post_e"].log_evidence,
                  atol=1e-6),
            within_sigma("NS logZ against quadrature", lz, se, quad, k=4),
            check(5.0 < float(arr(g["mu_s"]).mean()) < 11.0, "E[mu] in (5, 11)")]


def _c31(g, smoke, cpu):
    sd = arr(g["pooled"]).std(0)
    return [check(0.7 < sd[1] < 1.4, f"ensemble sd of the narrow axis {sd[1]:.3f} in (0.7, 1.4)"),
            check(float(np.corrcoef(arr(g["pooled"]).T)[0, 1]) > 0.85, "ensemble correlation > 0.85")]


CHECKS = {f"{i:02d}": globals()[f"_c{i:02d}"] for i in range(1, 32)}


# ---------------------------------------------------------------- runner

@contextlib.contextmanager
def _environment(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_example(number: str, device=None) -> dict:
    """The example's globals after ``runpy`` in a fresh working directory; ``device`` (when given) names
    ``BI_EXAMPLE_DEVICE`` for this run."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, _environment(BI_EXAMPLE_DEVICE=device):
        os.chdir(tmp)
        try:
            return runpy.run_path(path_of(number), run_name="__main__")
        finally:
            os.chdir(cwd)


def run(number: str) -> dict:
    """Run one example, count its kernel launches, check it; the readings as a dict."""
    import torch

    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    smoke = os.environ.get("BI_EXAMPLE_SMOKE") == "1"
    on_card = torch.cuda.is_available() and os.environ.get("BI_EXAMPLE_DEVICE", "cuda").startswith("cuda")
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = run_example(number)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    cpu = run_example(number, "cpu") if number in CPU_TWIN else None
    checks = CHECKS[number](g, smoke, cpu)
    return {"example": os.path.basename(path_of(number))[:-3], "smoke": smoke, "seconds": seconds,
            "launches": launches, "peak_mib": peak, "headline": HEADLINES[number](g), "checks": checks}


def main(argv) -> int:
    for number in argv or NUMBERS:
        print(json.dumps(run(number)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    sys.exit(main(sys.argv[1:]))
