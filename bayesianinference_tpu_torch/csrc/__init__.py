"""Build and load the hand-written CUDA kernels (``*.cu`` in this folder).

The sources have a plain C interface and are compiled by ``nvcc`` into one
shared library, which is loaded with :mod:`ctypes`.  The build happens at
first use, from these sources only, into ``build/`` at the repository
root, keyed by a hash of the sources and the compiler flags, so an edited
kernel is rebuilt and an unchanged one is reused.  There is no fallback: a
missing ``nvcc`` or a failed compile raises.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "find_nvcc", "load_library", "check"]

_HERE = Path(__file__).resolve().parent
SOURCES = ("se_covariance.cu", "cholesky.cu")
# No --use_fast_math: the SE exp and the Cholesky sqrt need full accuracy.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_DIR = _HERE.parent.parent / "build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x1, x2, variance, out, batch, n1, n2, d, stream
    "bi_se_covariance_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bi_se_covariance_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # k, l, batch, n, stream: the whole factorization in one launch
    "bi_cholesky_fused_f32": (_P, _P, _I, _I, _P),
    "bi_cholesky_fused_f64": (_P, _P, _I, _I, _P),
    # k, l, batch, n, nb, stream: six launches per nb-wide panel
    "bi_cholesky_blocked_f32": (_P, _P, _I, _I, _I, _P),
    "bi_cholesky_blocked_f64": (_P, _P, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin or "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile the kernels if this source hash has no library yet, load the
    library and declare every entry point's argument types."""
    nvcc = find_nvcc()
    out = BUILD_DIR / f"bi_kernels_{_source_hash()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(_HERE / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
