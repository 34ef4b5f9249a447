"""A CPU rehearsal of ``chip_smoke.py`` phase 21 (the multi-card engines on
a 4-shard mesh) at small sizes.  Not collected by pytest.

``python tests/phase21_rehearsal.py``
    Runs ``chip_smoke.phase_multi_card`` on a mesh of four CPU shards:
    21a-e at n = 1024 (21c and 21d at 512, 21e with 64 query points), 21f
    at 4096 rows, 21g at n = 2048 and 21h's NS runs in-process, capped at
    200 iterations.  It takes about 20 s.

On CPU tensors the ``se_covariance`` and ``cholesky`` ops run their plain
versions and launch no kernel, so the phase's launch gates could not pass.
The rehearsal therefore wraps the op functions that the sharded modules
call (``ops.gp_kernels.se_covariance``, ``ops.gp_kernels.cholesky`` and
the ``cholesky`` that ``parallel.sharded_chol`` imported) and adds one to
the kernels' launch counters per call.  Its counts are op calls, not kernel
launches: a call that the card would serve with several launches (the
blocked Cholesky above n = 640) counts once here.  ``torch.cuda.synchronize``
is made a no-op, as there is no card to wait for.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from bayesianinference_tpu_torch.ops import gp_kernels as gk  # noqa: E402
from bayesianinference_tpu_torch.parallel import sharded_chol  # noqa: E402

SIZES = dict(gp=dict(n=1024, m=64, chol_n=512, grad_n=512), conjugate=dict(rows=4096), big=dict(n=2048),
             ns=dict(max_iterations=200))


def _counting(fn, counter: str):
    """``fn`` adding one to ``gk.<counter>.launches`` a call (looked up at
    the call: the phase's kernel watch swaps the counted functions)."""
    def wrapped(*args, **kwargs):
        getattr(gk, counter).launches += 1
        return fn(*args, **kwargs)

    return wrapped


def main():
    torch.cuda.synchronize = lambda *a, **k: None
    gk.se_covariance = _counting(gk.se_covariance, "se_covariance_cuda")
    gk.cholesky = sharded_chol.cholesky = _counting(gk.cholesky, "cholesky_cuda")
    t = time.perf_counter()
    total = cs.phase_multi_card("CPU rehearsal", "cpu", None, **SIZES)
    print(f"op calls counted as launches {total}; {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
