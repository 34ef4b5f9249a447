"""Build and load the hand-written CUDA kernels (``*.cu`` in this folder).

The sources have a plain C interface and are compiled by ``nvcc``, one
process per source and all started together, each into a shared library
of its own, which is loaded with :mod:`ctypes`.  The build happens at
first use, from these sources only, into ``build/`` at the repository
root, keyed by a hash of the source and the compiler flags, so an edited
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

__all__ = ["SOURCES", "NVCC_FLAGS", "find_nvcc", "build", "load_library", "check"]

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
_L = ctypes.c_longlong
# x1, x2 | null, variance, lengthscale | null, nugget | null, out, batch, n1, n2, d,
# strides in elements (x1 and x2 batch, variance, lengthscale batch and feature,
# nugget batch and row), tile (0 | 32 | 64), stream
_SE = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _I, _P)
_SIGNATURES = {
    "bi_se_covariance_f32": _SE,
    "bi_se_covariance_f64": _SE,
    # k, l, batch, n, cluster (CTAs per matrix), stream: the whole factorization in one launch
    "bi_cholesky_fused_f32": (_P, _P, _I, _I, _I, _P),
    "bi_cholesky_fused_f64": (_P, _P, _I, _I, _I, _P),
    # k, l, batch, n, stream: one cooperative launch, every SM on each matrix in turn
    "bi_cholesky_grid_f32": (_P, _P, _I, _I, _P),
    "bi_cholesky_grid_f64": (_P, _P, _I, _I, _P),
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


def build(sources, flags=NVCC_FLAGS, build_dir=None) -> list:
    """Compile each of ``sources`` (paths) that has no library for its hash
    yet, one ``nvcc`` per source, all running at once; the libraries' paths
    in the order of ``sources``."""
    nvcc = find_nvcc()
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    outs, running = [], []
    for src in map(Path, sources):
        h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out = build_dir / f"{src.stem}_{h}.so"
        outs.append(out)
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *flags, "-o", tmp, str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            running.append((proc, tmp, out))
    failed = []
    for proc, tmp, out in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


class _Library:
    """The entry points of every built library, by name, each with its
    argument types declared."""

    def __init__(self, paths):
        self._libs = [ctypes.CDLL(str(p)) for p in paths]
        for name, argtypes in _SIGNATURES.items():
            fn = next((getattr(lib, name) for lib in self._libs if hasattr(lib, name)), None)
            if fn is None:
                raise RuntimeError(f"entry point {name} is in none of {[str(p) for p in paths]}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


@functools.lru_cache(maxsize=None)
def load_library() -> _Library:
    """Compile the kernels whose source hash has no library yet, load the
    libraries and declare every entry point's argument types."""
    return _Library(build([_HERE / s for s in SOURCES]))


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
