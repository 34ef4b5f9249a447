"""PyTorch/CUDA port of ``bayesianinference_tpu``: nested sampling of
Gaussian-process hyperparameters, with the GP covariance assembly and
Cholesky factorization as hand-written CUDA kernels for the H100.

The JAX package stays the reference; this package imports ``torch`` and
never ``jax``.  Work runs on the device of the tensors and
``torch.Generator`` the caller passes in; entry points that make new state
without tensor data put it on the CUDA card unless given ``device="cpu"``,
and raise where there is no card.
"""

import torch

# float32 matrix products must not run in TF32 (about three decimal
# digits): the GP covariance and its factorization need full precision to
# stay positive definite, which is why the JAX package pins
# Precision.HIGHEST for its Gram products.  False is PyTorch's default;
# it is set here so that nothing the port runs depends on that default.
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

# importing builds no kernel: csrc compiles them at their first launch
from . import core, dists, engines, models, ops, parallel, results  # noqa: E402

# loaded at first use: utils and viz (whose plots import matplotlib only
# when they draw) and bnn
_LAZY = ("bnn", "utils", "viz")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["bnn", "core", "dists", "engines", "models", "ops", "parallel", "results", "utils", "viz", "__version__"]
