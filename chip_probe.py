"""Where the hand-written Cholesky's time goes, on one NVIDIA GPU.

    python3 chip_probe.py

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

import collections
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
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
    k = gk.se_covariance(x, x, torch.ones(1, device="cuda")) + 0.1353 * torch.eye(n, device="cuda")
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
