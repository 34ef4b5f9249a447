"""The JAX package's readings of ``tests/test_bnn.py::test_bnn_end_to_end``'s
gates at ``chip_smoke.py`` 18a's two configurations, on the CPU in float32.
Not collected by pytest.

``python tests/bnn_gate_study.py``
    For each of ``chip_smoke.BNN_CONFIGS`` (the reference's defaults and
    the JAX test's own configuration): the JAX trainer on the test's data
    (n = 256), then the gates' quantities: mean |error| of the predictive
    mean at 31 points (gate < 0.2), the smallest predictive sd (> 0.03),
    the 3-sigma coverage (> 0.9), the loss over the first and last 100
    steps, and the network log evidence before and after training.  One
    JSON line per configuration.  18a keeps the JAX test's gates where
    every one holds for JAX.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bayesianinference_tpu.bnn import (  # noqa: E402
    network_log_evidence,
    regression_net,
    sample_trained_net,
    train_regression_net,
)


def main():
    jax.config.update("jax_platforms", "cpu")
    x, y = cs._sine_data()
    key = jax.random.PRNGKey(0)
    xq = np.linspace(-1.8, 1.8, 31)[:, None].astype(np.float32)
    for name, net_kw, train_kw in cs.BNN_CONFIGS:
        t0 = time.time()
        net = regression_net(**net_kw)
        trained = train_regression_net(net, key, jnp.asarray(x), jnp.asarray(y), **train_kw)
        pred = sample_trained_net(net, trained.params, jax.random.PRNGKey(1), jnp.asarray(xq), num_samples=200)
        mean, sd = np.asarray(pred.mean()), np.asarray(pred.std())
        err = np.abs(mean - np.sin(2 * xq[:, 0]))
        params0 = net.init({"params": key, "dropout": key}, jnp.asarray(x[:1]), deterministic=True)
        lz = [float(network_log_evidence(net, p, key, jnp.asarray(x), jnp.asarray(y), lambda2=0.0, alpha=0.5,
                                         sample_number=20)) for p in (params0, trained.params)]
        print(json.dumps(dict(config=name, mean_abs_err=float(err.mean()), min_sd=float(sd.min()),
                              coverage3=float(np.mean(err < 3 * sd)),
                              loss_first100=float(trained.history[:100].mean()),
                              loss_last100=float(trained.history[-100:].mean()), log_evidence_init=lz[0],
                              log_evidence_trained=lz[1], seconds=round(time.time() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
