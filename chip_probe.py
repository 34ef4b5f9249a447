"""Where the hand-written kernels' time goes, on one NVIDIA GPU.

    python3 chip_probe.py [--only se|cholesky] [--parent PATH]

The SE covariance (``csrc/se_covariance.cu``), at the main path's shapes
(B = 10 and B = 1 at n = 512, d = 3, float64 and float32; B = 1, n = 16384,
float32), device ms per call:

a. the symmetric call with the nugget fused, as the launcher picks the
   tile edge and at both edges forced, beside the two-input call on a copy
   of the data (what the mirrored tiles save) and its bound; also at
   B = 30 and 100 and at n = 2048 and 8192, where the tile edge is decided;
b. copies of the source built into ``build/`` with one stage switched off
   at a time (no exp, no store, no mirror; last, loads and differences
   only; their output is wrong, only the time counts), with write-back in
   place of streaming stores (also for the covariance-then-Cholesky pair,
   which shows whether the Cholesky finds K in the L2 either way), and the
   variant whose 32 x 32 tiles leave shared memory by bulk asynchronous
   copies beside the plain vector stores at the same tile edge;
c. with ``--parent PATH`` (a checkout of a commit whose SE kernel still
   took scaled data and no nugget), that tree's kernel on the same data,
   and its whole assembly (scaled copies, ``diag_embed``, add) beside it.

The Cholesky:

1. Both paths of ``csrc/cholesky.cu`` (forced through
   ``ops.gp_kernels._cholesky_launch``) beside ``torch.linalg.cholesky_ex``
   at n = 512, 1024, 2048, B = 1 and 10, float64 and float32: device ms
   per call (CUDA events around calls queued behind a ``torch.cuda._sleep``).
2. The blocked path at n = 16384, float32, split by kernel with
   torch.profiler.
3. The fused kernel's stages: copies of the source built into ``build/``
   with one stage switched off at a time (the tile factor, the row-block
   solves, the trailing tiles, the cluster barriers; last, all but the
   loads and barriers).  Their factors are wrong; only the time counts.

Each line ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import subprocess
from pathlib import Path

import torch

from bayesianinference_tpu_torch import csrc
from bayesianinference_tpu_torch.ops import gp_kernels as gk

SOURCE = Path(csrc.__file__).resolve().parent / "cholesky.cu"
# (text of the source, the same text inside #ifndef SWITCH ... #endif)
STAGES = {
    "factor": "      if (threadIdx.x < kTile) factor_tile_warp(d, ld, dinv);\n",
    "solve": "        if (threadIdx.x < kTile) solve_row(pa + threadIdx.x * ld, d, ld, dinv);\n",
    "tiles": "      if (rank < ntiles) fetch(rank);\n      for (int t = rank; t < ntiles; t += kCluster) {\n",
    "barriers": "      __threadfence();\n      cluster.sync();\n",
}
VARIANTS = {"full": (), "no factor": ("factor",), "no solve": ("solve",), "no tiles": ("tiles",),
            "no barriers": ("barriers",), "loads and barriers only": ("factor", "solve", "tiles")}


def dev_ms(call, reps: int = 10) -> float:
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def spd(b, n, dtype, g):
    a = torch.randn((b, n, n), generator=g, device="cuda", dtype=dtype)
    return a @ a.mT + n * torch.eye(n, device="cuda", dtype=dtype)


def stage_variants():
    """{variant: (fused f64 entry, fused f32 entry)} built from SOURCE."""
    text = SOURCE.read_text()
    for name, code in STAGES.items():
        assert text.count(code) >= 1, f"stage {name} not found in {SOURCE}"
        if name == "tiles":  # skip the tile loop by making it empty
            text = text.replace(code, code.replace("if (rank < ntiles)", "if (!SKIP_TILES && rank < ntiles)")
                                .replace("t < ntiles;", "!SKIP_TILES && t < ntiles;"))
        else:
            text = text.replace(code, f"#ifndef SKIP_{name.upper()}\n{code}#endif\n")
    text = "#ifndef SKIP_TILES\n#define SKIP_TILES 0\n#endif\n" + text
    out = csrc.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cholesky_stages.cu").write_text(text)
    procs = {}
    for variant, off in VARIANTS.items():
        flags = [f"-DSKIP_{s.upper()}" if s != "tiles" else "-DSKIP_TILES=1" for s in off]
        lib = out / f"stages_{variant.replace(' ', '_')}.so"
        procs[variant] = (lib, subprocess.Popen([csrc.find_nvcc(), *csrc.NVCC_FLAGS, *flags, "-o", str(lib),
                                                 str(out / "cholesky_stages.cu")]))
    fns = {}
    for variant, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the variant {variant!r}")
        handle = ctypes.CDLL(str(lib))
        pair = []
        for name in ("bi_cholesky_fused_f64", "bi_cholesky_fused_f32"):
            fn = getattr(handle, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[variant] = pair
    return fns


SE_SOURCE = Path(csrc.__file__).resolve().parent / "se_covariance.cu"
SE_VARIANTS = {"full": (), "write-back stores": ("-DSE_WRITE_BACK_STORES",), "no exp": ("-DSE_PROBE_NO_EXP",),
               "no store": ("-DSE_PROBE_NO_STORE",), "no mirror": ("-DSE_PROBE_NO_MIRROR",),
               "loads and differences only": ("-DSE_PROBE_NO_EXP", "-DSE_PROBE_NO_STORE", "-DSE_PROBE_NO_MIRROR"),
               "bulk async store (tile 32)": ("-DSE_BULK_STORE",), "plain stores (tile 32)": ()}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


@contextlib.contextmanager
def kernels_from(lib):
    """Route the port's launches to the entry points of ``lib``."""
    real = csrc.load_library
    csrc.load_library = lambda: lib
    try:
        yield
    finally:
        csrc.load_library = real


def se_variants():
    """{variant: library} of SE_SOURCE built with each variant's flags, all at once."""
    cholesky = csrc.build([SOURCE])[0]
    out = csrc.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, flags in SE_VARIANTS.items():
        lib = out / f"se_{variant.replace(' ', '_')}.so"
        procs[variant] = (lib, subprocess.Popen([csrc.find_nvcc(), *csrc.NVCC_FLAGS, *flags, "-o", str(lib),
                                                 str(SE_SOURCE)]))
    for variant, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the SE variant {variant!r}")
    return {variant: csrc._Library([lib, cholesky]) for variant, (lib, _) in procs.items()}


def parent_se(parent: Path):
    """(f64, f32) entry points of an earlier tree's SE kernel, one that
    still has the C signature (x1, x2, variance, out, batch, n1, n2, d,
    stream) on scaled data, built into ``build/probe``."""
    out = csrc.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "se_parent.so"
    subprocess.run([csrc.find_nvcc(), *csrc.NVCC_FLAGS, "-o", str(lib),
                    str(parent / "bayesianinference_tpu_torch" / "csrc" / "se_covariance.cu")], check=True)
    handle = ctypes.CDLL(str(lib))
    fns = []
    for name in ("bi_se_covariance_f64", "bi_se_covariance_f32"):
        fn = getattr(handle, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def probe_se(smi: str, parent):
    g = torch.Generator(device="cuda").manual_seed(0)
    variants = se_variants()
    old = parent_se(parent) if parent is not None else None
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, b, n, reps in ((torch.float64, 10, 512, 50), (torch.float32, 10, 512, 50), (torch.float64, 1, 512, 50),
                              (torch.float32, 30, 512, 20), (torch.float32, 100, 512, 20), (torch.float32, 10, 2048, 10),
                              (torch.float64, 10, 2048, 10), (torch.float64, 1, 8192, 5), (torch.float32, 1, 16384, 5)):
        x = torch.randn((1, n, 3), generator=g, device="cuda", dtype=dtype)  # shared by the batch, as on the main path
        var = 0.5 + torch.rand((b,), generator=g, device="cuda", dtype=dtype)
        scale = (0.5 + torch.rand((b, 1), generator=g, device="cuda", dtype=dtype)).expand(b, 3)
        nug = (0.01 + torch.rand((b, 1), generator=g, device="cuda", dtype=dtype)).expand(b, n)
        size = x.element_size()
        bound = b * (n * n + 2 * n * 3 + 3 + 3 + n) * size / HBM_BYTES_PER_S * 1e3
        head = f"{dtype} B={b} n={n} d=3"
        x2 = x.clone()
        sym = lambda **kw: dev_ms(lambda: gk.se_covariance_cuda(x, None, var, scale, nug, **kw), reps)  # noqa: E731
        two = lambda **kw: dev_ms(lambda: gk.se_covariance_cuda(x, x2, var, scale, None, **kw), reps)  # noqa: E731
        print(f"[se tiles] {head}: device ms symmetric+nugget as launched {sym():.4f}; tile 32 {sym(tile=32):.4f}, "
              f"64 {sym(tile=64):.4f}; two-input as launched {two():.4f}, tile 32 {two(tile=32):.4f}, 64 "
              f"{two(tile=64):.4f}; bound (bytes) {bound:.4f} | {smi}", flush=True)
        stages = {}
        want = gk.se_covariance_cuda(x, None, var, scale, nug)
        for variant, lib in variants.items():
            kw = {"tile": 32} if "tile 32" in variant else {}
            with kernels_from(lib):
                stages[variant] = dev_ms(lambda: gk.se_covariance_cuda(x, None, var, scale, nug, **kw), reps)
                if "bulk" in variant and not torch.equal(gk.se_covariance_cuda(x, None, var, scale, nug, **kw), want):
                    raise AssertionError(f"{head}: the bulk-store variant's K differs")
        del want
        if (b, n) == (10, 512):  # does the Cholesky, which reads K next, find it in the L2 either way?
            pair = {}
            for variant in ("full", "write-back stores"):
                with kernels_from(variants[variant]):
                    pair[variant] = dev_ms(lambda: gk.cholesky_cuda(gk.se_covariance_cuda(x, None, var, scale, nug)), reps)
            print(f"[se then cholesky] {head}: device ms of the pair, streaming stores {pair['full']:.4f}, write-back "
                  f"stores {pair['write-back stores']:.4f} | {smi}", flush=True)
        print(f"[se stages] {head}: device ms " + ", ".join(f"{v} {t:.4f}" for v, t in stages.items()) + f" | {smi}",
              flush=True)
        if old is not None:
            fn = old[0 if dtype == torch.float64 else 1]
            xs = (x / scale[:, None, :]).contiguous()
            out = torch.empty((b, n, n), device="cuda", dtype=dtype)
            kernel = dev_ms(lambda: fn(xs.data_ptr(), xs.data_ptr(), var.data_ptr(), out.data_ptr(), b, n, n, 3, stream),
                            reps)

            def assembly():
                inv = 1.0 / scale[:, None, :]
                a1 = (x * inv).expand(b, n, 3).contiguous()
                a2 = (x * inv).expand(b, n, 3).contiguous()
                fn(a1.data_ptr(), a2.data_ptr(), var.data_ptr(), out.data_ptr(), b, n, n, 3, stream)
                return out + torch.diag_embed(nug)

            print(f"[se parent] {head}: device ms the earlier kernel alone {kernel:.4f}, with its scaled copies, "
                  f"diag_embed and add {dev_ms(assembly, reps):.4f} | {smi}", flush=True)
        del x, x2, var, scale, nug
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("se", "cholesky"), default=None)
    ap.add_argument("--parent", type=Path, default=None, help="a checkout of an earlier commit, for its SE kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.only != "cholesky":
        probe_se(smi, args.parent)
    if args.only != "se":
        probe_cholesky(smi)


def probe_cholesky(smi: str):
    g = torch.Generator(device="cuda").manual_seed(0)
    fused_nb, blocked_nb = gk._cholesky_route(1)[1], gk._cholesky_route(1 << 20)[1]

    for dtype in (torch.float64, torch.float32):
        for n in (512, 1024, 2048):
            for b in (1, 10):
                k = spd(b, n, dtype, g)
                print(f"[paths] {dtype} n={n} B={b}: device ms fused "
                      f"{dev_ms(lambda: gk._cholesky_launch(k, 'fused', fused_nb)):.4f}, blocked "
                      f"{dev_ms(lambda: gk._cholesky_launch(k, 'blocked', blocked_nb)):.4f}, cholesky_ex "
                      f"{dev_ms(lambda: torch.linalg.cholesky_ex(k)):.4f} | {smi}", flush=True)

    n = 16384
    x = torch.randn((1, n, 3), generator=g, device="cuda")
    k = gk.se_covariance(x, None, 1.0, None, 0.1353)[0]
    gk.cholesky(k)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gk.cholesky(k)
        torch.cuda.synchronize()
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.split("<")[0].split("::")[-1]
            per[name][0] += 1
            per[name][1] += e.time_range.elapsed_us() / 1e3
    print(f"[blocked split] f32 n={n}: " + ", ".join(f"{name} x{c} {ms:.2f} ms" for name, (c, ms) in sorted(
        per.items(), key=lambda kv: -kv[1][1])) + f"; cholesky_ex {dev_ms(lambda: torch.linalg.cholesky_ex(k), 3):.2f} "
          f"ms | {smi}", flush=True)
    del k, x
    torch.cuda.empty_cache()

    fns = stage_variants()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, idx in ((torch.float64, 0), (torch.float32, 1)):
        for b, n in ((10, 512), (1, 512), (1, 1024)):
            k = spd(b, n, dtype, g)
            out = torch.empty_like(k)
            times = {v: dev_ms(lambda fn=f[idx]: fn(k.data_ptr(), out.data_ptr(), b, n, stream), 20)
                     for v, f in fns.items()}
            print(f"[fused stages] {dtype} B={b} n={n}: device ms " + ", ".join(
                f"{v} {t:.4f}" for v, t in times.items()) + f" | {smi}", flush=True)


if __name__ == "__main__":
    main()
