"""The port's quasi-Bayesian networks (``bnn/``) against the JAX package,
on the CPU.

The JAX dropout masks are read with a flax method interceptor: each
``nn.Dropout`` is called on ``ones_like(x)``, which gives its mask as keep /
(1 - p), and returns ``x * mask``, which is the JAX pass itself to the last
bit or so.  The port takes those masks as its input.  Parity at depth 2,
width 16, for both heads with and without batch normalization (the JAX side
through ``mutable=["batch_stats"]``, as ``tests/test_bnn.py`` applies a
batch-normalized net; the JAX losses cannot apply one otherwise, so for
those nets the JAX loss is composed here from ``gaussian_loss`` and
``alpha_divergence_loss``): the forward pass (1e-12), ``regression_loss``
at every alpha form and its gradient (1e-12, 1e-10), ``network_log_evidence``
in both call forms (1e-12), the updated running statistics (1e-12), and
``sample_trained_net`` (1e-12).  Training replays ``train_regression_net``'s
key schedule (the minibatch ``randint`` and each step's masks) for a few
steps: float64 at 1e-10 (the JAX net's Dense layers take float64
parameters through an interceptor: flax makes them float32 by default) and
float32 at 1e-5.  Oracle tests are ``tests/test_bnn.py``'s.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu import bnn as jb
from bayesianinference_tpu_torch import bnn as tb
from bayesianinference_tpu_torch import interop

torch.set_num_threads(1)
DEPTH, WIDTH = 2, 16
CASES = [(em, bn) for em in ("HeteroScedastic", "HomoScedastic") for bn in (False, True)]
IDS = [f"{em[:6]}-{'bn' if bn else 'plain'}" for em, bn in CASES]


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_pass(net, variables, x, key, mutable=False):
    """(output, masks) of one stochastic JAX pass; with ``mutable`` the
    output is flax's (out, {"batch_stats": ...}) pair."""
    masks = []

    def read_masks(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, nn.Dropout) and ctx.method_name == "__call__":
            m = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(np.asarray(m))
            return args[0] * m
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(read_masks):
        out = net.apply(variables, x, deterministic=False, rngs={"dropout": key},
                        **(dict(mutable=["batch_stats"]) if mutable else {}))
    return out, masks


def jax_masks(net, variables, x, keys, mutable=False):
    """The masks of one pass per key, stacked: [k, n, width] per block."""
    per_key = [jax_pass(net, variables, x, k, mutable)[1] for k in keys]
    return [T(np.stack([m[i] for m in per_key])) for i in range(len(per_key[0]))]


def f64_dense(next_fun, args, kwargs, ctx):
    """Interceptor: flax's Dense layers take float64 parameters."""
    if isinstance(ctx.module, nn.Dense) and ctx.method_name == "__call__":
        object.__setattr__(ctx.module, "param_dtype", jnp.float64)
    return next_fun(*args, **kwargs)


def _data(n=12, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=n)


@functools.lru_cache(maxsize=None)
def _nets(em, bn, d=3, p=0.25, seed=9):
    """A JAX net with perturbed float64 variables, and the port's net and
    state from them (made once per case; no test changes them)."""
    jn = jb.regression_net(em, depth=DEPTH, layer_size=WIDTH, dropout_probability=p, batch_normalization=bn)
    key = jax.random.PRNGKey(3)
    with nn.intercept_methods(f64_dense):
        v = jn.init({"params": key, "dropout": key}, jnp.zeros((1, d)), deterministic=True)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    rng = np.random.default_rng(seed)
    # move every leaf off its initial value (biases, scales, running stats)
    v = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape))
                                               for a in leaves])
    if bn:
        v = {**v, "batch_stats": jax.tree_util.tree_map(jnp.abs, v["batch_stats"])}
    tn = tb.regression_net(em, depth=DEPTH, layer_size=WIDTH, dropout_probability=p, batch_normalization=bn)
    return jn, v, tn, interop.regression_net_state_from_numpy(_np(v), device="cpu")


def _jax_loss(jn, v, key, x, y, alpha, k, bn):
    """The JAX package's regression_loss; for a batch-normalized net the same
    loss composed through ``mutable=["batch_stats"]``."""
    if not bn:
        return jb.regression_loss(jn, v, key, x, y, alpha=alpha, sample_number=k)

    def one(kk):
        return jn.apply(v, x, deterministic=False, rngs={"dropout": kk}, mutable=["batch_stats"])[0]

    y = jnp.asarray(y).reshape(-1)
    if alpha is None:
        out = one(key)
        return jnp.mean(jb.gaussian_loss(y, out[:, 0], out[:, 1]))
    outs = jax.vmap(one)(jax.random.split(key, k))
    return jnp.mean(jb.alpha_divergence_loss(jb.gaussian_loss(y[None], outs[..., 0], outs[..., 1]), alpha, axis=0))


@pytest.mark.parametrize("em, bn", CASES, ids=IDS)
def test_forward_and_batch_statistics_match_jax_on_its_masks(em, bn):
    jn, v, tn, state = _nets(em, bn)
    x, _ = _data()
    key = jax.random.PRNGKey(11)
    out, masks = jax_pass(jn, v, jnp.asarray(x), key, mutable=bn)
    got = tn(T(x), [T(m) for m in masks], params=state, mutable=bn)
    if bn:
        (out, updates), (got, stats) = out, got
        for i in range(DEPTH):
            for name in ("mean", "var"):
                close(stats[f"norm{i}_{name}"].numpy(), updates["batch_stats"][f"BatchNorm_{i}"][name], rtol=1e-12)
    close(got.numpy(), out, rtol=1e-12, atol=1e-14)
    # the deterministic pass (running averages)
    close(tn(T(x), params=state).detach().numpy(), jn.apply(v, jnp.asarray(x), deterministic=True), rtol=1e-12,
          atol=1e-14)
    # k passes as one batch: batch statistics per pass
    keys = jax.random.split(key, 3)
    k_masks = jax_masks(jn, v, jnp.asarray(x), keys, mutable=bn)
    batched = tn(T(x), k_masks, params=state)
    for j, kk in enumerate(keys):
        want = jax_pass(jn, v, jnp.asarray(x), kk, mutable=bn)[0]
        close(batched[j].detach().numpy(), want[0] if bn else want, rtol=1e-12, atol=1e-14)


@functools.lru_cache(maxsize=None)
def _loss_masks(em, bn, one_pass, seed, k):
    """The JAX masks of the loss test's passes (one with ``PRNGKey(seed)``,
    or ``k`` from its split), read once for every alpha of a net."""
    jn, v, _, _ = _nets(em, bn)
    x, _ = _data()
    key = jax.random.PRNGKey(seed)
    keys = [key] if one_pass else jax.random.split(key, k)
    masks = jax_masks(jn, v, jnp.asarray(x), keys, mutable=bn)
    return [m[0] for m in masks] if one_pass else masks


@pytest.mark.parametrize("em, bn", CASES, ids=IDS)
@pytest.mark.parametrize("alpha", [None, 0.5, 0.0, np.inf, -np.inf])
def test_regression_loss_and_gradient_match_jax(em, bn, alpha):
    jn, v, tn, state = _nets(em, bn)
    x, y = _data()
    key, k = jax.random.PRNGKey(5), 4
    masks = _loss_masks(em, bn, alpha is None, 5, k)

    def loss_of(params):
        return _jax_loss(jn, {**v, "params": params}, key, jnp.asarray(x), jnp.asarray(y), alpha, k, bn)

    want, want_g = jax.value_and_grad(loss_of)(v["params"])
    p = {name: t.clone().requires_grad_(not name.endswith(("_mean", "_var"))) for name, t in state.items()}
    got = tb.regression_loss(tn, p, None, T(x), T(y), alpha=alpha, sample_number=k, masks=masks)
    close(float(got.detach()), float(want), rtol=1e-12)
    names = [n for n, t in p.items() if t.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(got, [p[n] for n in names])))
    want_grads = interop.regression_net_state_from_numpy({**_np(v), "params": _np(want_g)}, device="cpu")
    for n in names:
        close(grads[n].numpy(), want_grads[n], rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("em, bn", CASES, ids=IDS)
def test_network_log_evidence_both_forms_match_jax(em, bn):
    jn, v, tn, state = _nets(em, bn)
    x, y = _data()
    key, k, lam = jax.random.PRNGKey(8), 6, 1e-3
    masks = jax_masks(jn, v, jnp.asarray(x), jax.random.split(key, k), mutable=bn)
    trained = jb.TrainedRegressionNet(params=v, history=jnp.zeros(3), net=jn, alpha=0.5, sample_number=k,
                                      weight_decay=lam)
    if bn:  # the JAX functions cannot apply the net: the same sum, composed
        want = -(_jax_loss(jn, v, key, jnp.asarray(x), jnp.asarray(y), 0.5, k, bn)
                 + jb.net_regularization_loss(v, lam, 2))
        want_bundle = want
    else:
        want = jb.network_log_evidence(jn, v, key, jnp.asarray(x), jnp.asarray(y), lambda2=lam, alpha=0.5,
                                       sample_number=k)
        want_bundle = jb.network_log_evidence(trained, key, jnp.asarray(x), jnp.asarray(y))
    got = tb.network_log_evidence(tn, state, None, T(x), T(y), lambda2=lam, alpha=0.5, sample_number=k, masks=masks)
    bundle = interop.trained_regression_net_from_numpy(trained, tn, device="cpu")
    got_bundle = tb.network_log_evidence(bundle, None, T(x), T(y), masks=masks)
    close(float(got), float(want), rtol=1e-12)
    close(float(got_bundle), float(want_bundle), rtol=1e-12)
    assert bundle.alpha == 0.5 and bundle.sample_number == k and bundle.weight_decay == lam
    with pytest.raises(TypeError, match="bundle form"):
        tb.network_log_evidence(bundle, None, T(x), T(y), 0.0)


@pytest.mark.parametrize("em", ["HeteroScedastic", "HomoScedastic"])
def test_sample_trained_net_matches_jax_on_its_masks(em):
    jn, v, tn, state = _nets(em, False)
    xq = np.linspace(-1.5, 1.5, 9 * 3).reshape(9, 3)
    key, s = jax.random.PRNGKey(1), 25
    want = jb.sample_trained_net(jn, v, key, jnp.asarray(xq), num_samples=s)
    masks = jax_masks(jn, v, jnp.asarray(xq), jax.random.split(key, s))
    got = tb.sample_trained_net(tn, state, None, T(xq), num_samples=s, masks=masks)
    close(got.mean().numpy(), want.mean(), rtol=1e-12, atol=1e-14)
    close(got.std().numpy(), want.std(), rtol=1e-12)
    drawn = tb.sample_trained_net(tn, state, torch.Generator().manual_seed(0), T(xq), num_samples=s)
    assert drawn.mean().shape == (9,) and bool(torch.all(drawn.std() > 0))


def _replayed_steps(jn, x, y, key, num_steps, alpha, k, bs, dtype):
    """The JAX trainer's initial variables and each step's (indices, masks):
    ``predict.py``'s key schedule, the masks read from an eager pass."""
    k_init, k_train = jax.random.split(key)
    ctx = nn.intercept_methods(f64_dense) if dtype == np.float64 else None
    if ctx is not None:
        with ctx:
            v = jn.init({"params": k_init, "dropout": k_init}, jnp.asarray(x[:1]), deterministic=True)
    else:
        v = jn.init({"params": k_init, "dropout": k_init}, jnp.asarray(x[:1]), deterministic=True)
    n = x.shape[0]
    draws = []
    for kk in jax.random.split(k_train, num_steps):
        k_batch, k_loss = jax.random.split(kk)
        idx = np.asarray(jax.random.randint(k_batch, (bs,), 0, n)) if bs < n else None
        xb = x if idx is None else x[idx]
        keys = [k_loss] if alpha is None else jax.random.split(k_loss, k)
        masks = jax_masks(jn, v, jnp.asarray(xb), keys)
        masks = [m[0] if alpha is None else m for m in masks]
        draws.append(tb.BNNStepDraws(None if idx is None else torch.tensor(idx, dtype=torch.int64),
                                     [m.to(torch.float64 if dtype == np.float64 else torch.float32) for m in masks]))
    return v, draws


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-10), (np.float32, 1e-5)], ids=["f64", "f32"])
@pytest.mark.parametrize("em, alpha, batch_size, weight_decay", [
    ("HeteroScedastic", 0.5, None, 0.0), ("HomoScedastic", None, 8, 1e-3)], ids=["hetero-alpha", "homo-minibatch"])
def test_training_steps_match_train_regression_net(dtype, rtol, em, alpha, batch_size, weight_decay):
    x, y = _data(n=16, d=2, seed=4)
    x, y = x.astype(dtype), y.astype(dtype)
    jn = jb.regression_net(em, depth=DEPTH, layer_size=WIDTH, dropout_probability=0.25)
    key, steps, k = jax.random.PRNGKey(2), 4, 5
    kw = dict(alpha=alpha, sample_number=k, weight_decay=weight_decay, learning_rate=3e-2, num_steps=steps,
              batch_size=batch_size)
    if dtype == np.float64:
        with nn.intercept_methods(f64_dense):
            want = jb.train_regression_net(jn, key, jnp.asarray(x), jnp.asarray(y), **kw)
    else:
        want = jb.train_regression_net(jn, key, jnp.asarray(x), jnp.asarray(y), **kw)
    v0, draws = _replayed_steps(jn, x, y, key, steps, alpha, k, batch_size or x.shape[0], dtype)
    tn = tb.regression_net(em, depth=DEPTH, layer_size=WIDTH, dropout_probability=0.25)
    got = tb.train_regression_net(tn, None, T(x), T(y), initial_params=interop.regression_net_state_from_numpy(
        _np(v0), device="cpu"), draws=draws, **kw)
    want_state = interop.regression_net_state_from_numpy(_np(want.params), device="cpu")
    assert set(got.params) == set(want_state)
    for name, t in got.params.items():
        # flax keeps log_precision in float64 under x64 (its zeros
        # initializer's default dtype): the carried-over one stays so
        assert t.dtype == want_state[name].dtype
        close(t.numpy(), want_state[name], rtol=rtol, atol=rtol * 1e-3)
    close(got.history.numpy(), want.history, rtol=rtol)
    assert got.alpha == alpha and got.sample_number == k and got.weight_decay == weight_decay


def test_batch_normalized_net_cannot_be_trained():
    """The JAX trainer raises for such a net (flax's batch_stats collection
    is immutable in its loss); the port says so instead of training it."""
    x, y = _data()
    jn = jb.regression_net(depth=DEPTH, layer_size=WIDTH, batch_normalization=True)
    with pytest.raises(Exception, match="batch_stats"):
        jb.train_regression_net(jn, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y), num_steps=2)
    tn = tb.regression_net(depth=DEPTH, layer_size=WIDTH, batch_normalization=True)
    with pytest.raises(ValueError, match="batch-normalized"):
        tb.train_regression_net(tn, None, T(x), T(y), num_steps=2)


# ---------------------------------------------------------------------------
# tests/test_bnn.py's checks, on the port
# ---------------------------------------------------------------------------


def test_gaussian_loss_parameterizations():
    y, yp, v = 1.0, 1.5, 0.7
    lp = float(tb.gaussian_loss(y, yp, np.log(1 / v), "LogPrecision"))
    lv = float(tb.gaussian_loss(y, yp, v, "Variance"))
    ls = float(tb.gaussian_loss(y, yp, np.sqrt(v), "StandardDeviation"))
    np.testing.assert_allclose(lp, 0.25 / v + np.log(v), rtol=1e-12)
    np.testing.assert_allclose(lv, lp, rtol=1e-12)
    np.testing.assert_allclose(ls, lp, rtol=1e-12)
    with pytest.raises(ValueError, match="parameterization"):
        tb.gaussian_loss(y, yp, v, "Precision")


def test_alpha_divergence_limits():
    losses = T(np.random.default_rng(0).normal(size=20))
    close(float(tb.alpha_divergence_loss(losses, 0)), float(losses.mean()), rtol=1e-10)
    close(float(tb.alpha_divergence_loss(losses, np.inf)), float(losses.min()), rtol=1e-15)
    close(float(tb.alpha_divergence_loss(losses, -np.inf)), float(losses.max()), rtol=1e-15)
    close(float(tb.alpha_divergence_loss(losses, 1e-6)), float(losses.mean()), rtol=0, atol=1e-4)
    assert float(tb.alpha_divergence_loss(losses, 2.0)) < float(losses.mean())
    for a in (2.0, -0.7):
        close(float(tb.alpha_divergence_loss(losses, a)), float(jb.alpha_divergence_loss(jnp.asarray(losses), a)),
              rtol=1e-13)


def test_regularization_loss():
    params = {"a": T([1.0, -2.0]), "b": T([[3.0]])}
    np.testing.assert_allclose(float(tb.net_regularization_loss(params, 0.5, 2)), 0.5 * (1 + 4 + 9))
    np.testing.assert_allclose(float(tb.net_regularization_loss(params, 1.0, 0)), 3.0)
    np.testing.assert_allclose(float(tb.net_regularization_loss(params, [0.5, 1.0], [2, 0])), 0.5 * 14 + 3.0)
    # the batch-normalized net's running averages count, as the JAX sum
    # over its variables dict counts them
    _, v, _, state = _nets("HeteroScedastic", True)
    close(float(tb.net_regularization_loss(state, 0.3, 2)), float(jb.net_regularization_loss(v, 0.3, 2)),
          rtol=1e-13)
    assert tb.net_regularization_loss(state, 1.0, 0) == jb.net_regularization_loss(v, 1.0, 0)


def test_homoscedastic_head():
    net = tb.regression_net("HomoScedastic", depth=1, layer_size=8, dropout_probability=0.0)
    x = torch.zeros((4, 1))
    out = net(x, params=net.init(torch.Generator().manual_seed(0), x))
    assert out.shape == (4, 2)
    np.testing.assert_allclose(out[:, 1].detach().numpy(), float(out[0, 1]))


def test_batchnorm_variant():
    net = tb.regression_net(depth=2, layer_size=16, batch_normalization=True)
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 2)), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    out, updates = net(x, net.draw_masks(g, 8), params=net.init(g, x), mutable=True)
    assert out.shape == (8, 2)
    assert set(updates) == {"norm0_mean", "norm0_var", "norm1_mean", "norm1_var"}
    with pytest.raises(ValueError, match="error_model"):
        tb.regression_net("Heteroscedastic")


def _sine(n=256):
    """tests/test_bnn.py::test_bnn_end_to_end's data."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)
    return x, y


@pytest.mark.slow
def test_bnn_end_to_end():
    """tests/test_bnn.py's slow end-to-end test; ``chip_smoke.py`` phase 18a
    runs it on the card."""
    x, y = _sine()
    net = tb.regression_net(depth=2, layer_size=48, dropout_probability=0.1)
    g = torch.Generator().manual_seed(0)
    trained = tb.train_regression_net(net, g, T(x), T(y), alpha=0.5, sample_number=5, num_steps=1500,
                                      learning_rate=3e-3)
    assert float(trained.history[-100:].mean()) < float(trained.history[:100].mean())
    xq = np.linspace(-1.8, 1.8, 31)[:, None].astype(np.float32)
    pred = tb.sample_trained_net(net, trained.params, torch.Generator().manual_seed(1), T(xq), num_samples=200)
    mean, std = pred.mean().numpy(), pred.std().numpy()
    truth = np.sin(2 * xq[:, 0])
    assert np.mean(np.abs(mean - truth)) < 0.2
    assert np.all(std > 0.03)
    assert np.mean(np.abs(mean - truth) < 3 * std) > 0.9
    lz_trained = float(tb.network_log_evidence(net, trained.params, g, T(x), T(y), lambda2=0.0, alpha=0.5,
                                               sample_number=20))
    lz_auto = float(tb.network_log_evidence(trained, g, T(x), T(y), sample_number=20))
    assert np.isfinite(lz_auto)
    lz_init = float(tb.network_log_evidence(net, net.init(torch.Generator().manual_seed(0), T(x[:1])), g, T(x), T(y),
                                            lambda2=0.0, alpha=0.5, sample_number=20))
    assert np.isfinite(lz_trained) and lz_trained > lz_init
