"""The three-factor line form of the minor-axis kernel (K1, K9, K20) above
n = 4096 on the card: held against its plain versions, timed beside the
stage form it replaced, and beside two designs it did not take.

Run from the repository root on a machine with the GPU:

    python3 tools/long_line_ab.py [--check] [--times] [--variants]
                                  [--turns N]

``--check``: at every length of ``minor_fft._LONG_STEP`` the library's
geometry (``launched_geometry``) equals the wrapper's, and K1, K20 and K9
(n_in = 1, n/2 + 1, n - 1) meet their plain versions on batches of 1 and
131 (f32 1e-5, bf16 8e-3; forward and inverse, scale 1 and 1/n); each
length is printed with its blocks an SM (the occupancy API, from a
query of the tool's own built into ``build/long_line_ab/occupancy/``)
and ptxas's registers and spills of its f32 K1 kernel.

``--times``: K1 at every length at ~1.3 GB a call ((10000, 8320), (10000,
8192), (5000, 16384), (10000, 7680) and the other seven) by CUDA events
(median of 20 after two warm-up calls), the line form and the stage form
(``stages=True``) in turns (line, stages, stages, line; ``--turns`` times),
then ``torch.fft.fft``, the plain version and a device copy of the same
bytes (the floor); the Bluestein path ``fft`` of (10000, 4099), K9 (5000
-> 8192) and K20 (5, 16384) beside their stage forms.

``--variants``: patched copies of the minor-axis sources
(``minor_fft.cu``, ``minor_line_*.cu`` and ``minor_fft.cuh``), one nvcc a
source, all started together, linked into ``build/long_line_ab/<name>/``:

- ``l1``: the twiddles of passes 1 and 2 read from the full n-table in
  device memory through the read-only cache (``__ldg``) instead of the
  three small tables in shared memory;
- ``pair4096``: n = 4096 on the 64 x 64 four-step on lane pairs (the
  form before the three-factor one took 4096) instead of 16 x 16 x 16.

Each is held against the plain version and timed in turns against the
tree's library: ``l1`` at (10000, 8320), (10000, 8192) and (5000, 16384),
``pair4096`` at (40000, 4096); ptxas's report of each variant's
three-factor kernels is printed. Every line names the card and its power
limit; ``--times`` ends with a JSON object of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import tpufft_torch  # noqa: E402
from tools import ptxas_compare, variant_build  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import fused_fft, minor_fft  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 8e-3
RATE = [0.0]  # the card's copy rate, bytes/s, measured at the start
# the three-factor lengths at ~1.3 GB a call: Bluestein's 8320, 8192, 16384
# and 7680 first
SHAPES = ((10_000, 8320), (10_000, 8192), (5000, 16384), (10_000, 7680),
          (20_000, 4096), (18_800, 4320), (15_900, 5120), (13_200, 6144),
          (7900, 10240), (6600, 12288), (5300, 15360))
SRC_DIR = "tpufft_torch/csrc"
OUT = "build/long_line_ab"
# design (b): the twiddles from the full n-table through the read-only cache
STAGE_ABC = """  for (int i = t; i < N1 * N2; i += TH)
    table[S::ta + i] = __ldg(&tw[(i / N2) * (i % N2) * N3]);
  for (int i = t; i < N1 * N3; i += TH)
    table[S::tb + i] = __ldg(&tw[(i / N3) * (i % N3)]);
  for (int i = t; i < N2 * N3; i += TH)
    table[S::tc + i] = __ldg(&tw[N1 * (i / N3) * (i % N3)]);
"""
TW1 = "cmul(y, long_twiddle<S>(table, k1, j2, j3))"
TW2 = "cmul(y, table[S::tc + k2 * N3 + j3])"
TABLE = "tc = tb + N1 * N3, table = tc + N2 * N3;"
POW2_2048 = "  X(2048, 32, 64, 2, 128)\n"
LONG_4096 = "  X(4096, 16, 16, 16, 256, 257, 16)     \\\n"
# blocks an SM of K1's f32 three-factor kernel at each length
OCCUPANCY = """#include "minor_fft.cuh"

namespace tpufft_minor {

#define TPUFFT_OCCUPANCY(n_, n1, n2, n3, th, p1, p2)                  \\
  case n_: {                                                          \\
    using S = LongStep<n1, n2, n3, th, p1, p2>;                       \\
    auto* kernel = minor_long_kernel<float, S, false, false>;         \\
    cudaError_t err = allow_smem(kernel, S::smem);                    \\
    if (err == cudaSuccess)                                           \\
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \\
          per_sm, kernel, S::threads, S::smem);                       \\
    return (int)err;                                                  \\
  }

int long_occupancy(int n, int* per_sm) {
  switch (n) { TPUFFT_MINOR_LONG(TPUFFT_OCCUPANCY) }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tpufft_minor

extern "C" int tpufft_long_occupancy(int n, int* per_sm) {
  return tpufft_minor::long_occupancy(n, per_sm);
}
"""


def variants() -> dict:
    cuh = open(os.path.join(SRC_DIR, "minor_fft.cuh")).read()
    for mark in (STAGE_ABC, TW1, TW2, TABLE, POW2_2048, LONG_4096):
        assert cuh.count(mark) == 1, f"marker not unique: {mark!r}"
    l1 = (cuh.replace(STAGE_ABC, "")
          .replace(TW1, "cmul(y, __ldg(&tw[k1 * (N3 * j2 + j3)]))")
          .replace(TW2, "cmul(y, __ldg(&tw[N1 * k2 * j3]))")
          .replace(TABLE, "tc = tb + N1 * N3, table = ta;"))
    pair4096 = (cuh.replace(LONG_4096, "").replace(
        POW2_2048, "  X(2048, 32, 64, 2, 128)    \\\n"
        "  X(4096, 64, 64, 4, 256)\n"))
    return {"l1": l1, "pair4096": pair4096}


def build(texts: dict) -> dict:
    """Each variant's minor-axis sources, one nvcc a source (all variants'
    started together), then one link a variant; the library paths."""
    t0 = time.perf_counter()
    built = variant_build.build(
        OUT, "minor_fft.cuh", texts,
        lambda f: f == "minor_fft.cu" or (f.startswith("minor_line_")
                                          and f.endswith(".cu")))
    for name, (_, log) in built.items():
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s; ptxas, "
              f"three-factor kernels: {report(log)}", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def report(text: str) -> str:
    """ptxas's registers and spill stores of each minor_long_kernel in a
    build log (tools/ptxas_compare.py reads and demangles it)."""
    rows = ptxas_compare._report(text)
    return "; ".join(
        f"{ptxas_compare._key(k).replace('tpufft_minor::', '')}: "
        f"{v[0]} registers, {v[1]} bytes spill stores"
        for k, v in sorted(rows.items()) if "minor_long_kernel" in k)


def _hold(what, got, ref, dtype):
    err = chip_smoke.pair_err(got, ref)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    chip_smoke.check(err < tol, f"{what}: {err:.3e} >= {tol}")
    return err


def occupancy_lib() -> ctypes.CDLL:
    """``OCCUPANCY`` built against the tree's ``minor_fft.cuh`` into
    ``build/long_line_ab/occupancy/``."""
    out = os.path.join(OUT, "occupancy")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "occupancy.cu")
    with open(src, "w") as f:
        f.write(OCCUPANCY)
    lib = os.path.abspath(os.path.join(out, "lib.so"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-I", SRC_DIR,
                    "-shared", "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).tpufft_long_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def occupancy(fn, n: int) -> int:
    out = ctypes.c_int(0)
    err = fn(n, ctypes.byref(out))
    chip_smoke.check(err == 0, f"occupancy at {n}: CUDA error {err}")
    return out.value


def check() -> None:
    blocks = occupancy_lib()
    log = _build.build().with_suffix(".log").read_text()
    print("ptxas, three-factor kernels: " + report(log), flush=True)
    for n in sorted(minor_fft._LONG_STEP):
        got = minor_fft.launched_geometry(n)
        want = minor_fft.line_geometry(n)
        chip_smoke.check(got == {"form": "lines", **want},
                         f"n={n}: library {got}, wrapper {want}")
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (1, 131):
                xr, xi = chip_smoke._planes((rows, n), dtype, seed=n + rows)
                st = torch.cat([xr, xi], -1).contiguous()
                for inverse, scale in ((False, 1.0), (True, 1.0 / n),
                                       (False, 1.0 / n), (True, 1.0)):
                    kw = dict(inverse=inverse, scale=scale)
                    key = str(dtype).split(".")[-1]
                    e = _hold(f"K1 ({rows}, {n}) {dtype} {kw}",
                              minor_fft.fft_minor(xr, xi, **kw),
                              minor_fft.fft_minor_reference(xr, xi, **kw),
                              dtype)
                    out = fused_fft.fft_minor_fused(st, **kw)
                    ref = fused_fft.fft_minor_fused_reference(st, **kw)
                    e = max(e, _hold(f"K20 ({rows}, {n}) {dtype} {kw}",
                                     (out[:, :n], out[:, n:]),
                                     (ref[:, :n], ref[:, n:]), dtype))
                    for n_in in (1, n // 2 + 1, n - 1):
                        pr = xr[:, :n_in].contiguous()
                        pi = xi[:, :n_in].contiguous()
                        e = max(e, _hold(
                            f"K9 ({rows}, {n_in} -> {n}) {dtype} {kw}",
                            minor_fft.fft_minor_padded(pr, pi, n=n, **kw),
                            minor_fft.fft_minor_padded_reference(
                                pr, pi, n=n, **kw), dtype))
                    worst[key] = max(worst.get(key, 0.0), e)
        torch.cuda.synchronize()
        print(f"  K1/K20/K9 n={n} {minor_fft.line_split(n)} "
              f"{minor_fft.line_geometry(n)}: blocks an SM "
              f"{occupancy(blocks, n)}; max normalized error {worst}",
              flush=True)


def _turns(fns: dict, turns: int) -> dict:
    """Each callable timed in turns a, b, b, a (``turns`` rounds); the
    median of each one's medians, and its range."""
    got = {k: [] for k in fns}
    keys = list(fns)
    for _ in range(turns):
        for k in keys + keys[::-1]:
            got[k].append(chip_smoke._time_ms(fns[k]))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def _show(label, t, card, extra=""):
    print(f"{label} [{card}]: " + ", ".join(
        f"{k} " + "/".join(f"{x:.4f}" for x in v) for k, v in t.items())
        + extra, flush=True)


def times(turns: int, card: str) -> dict:
    out = {}
    for rows, n in SHAPES:
        xr, xi = chip_smoke._device_planes((rows, n), seed=n)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        kw = dict(inverse=False, scale=1.0)
        err = chip_smoke.pair_err(minor_fft.fft_minor(xr, xi, **kw),
                                  minor_fft.fft_minor(xr, xi, stages=True,
                                                      **kw))
        chip_smoke.check(err < F32_TOL, f"K1 ({rows}, {n}) line vs stages")
        t = _turns({"line": lambda: minor_fft.fft_minor(xr, xi, **kw),
                    "stages": lambda: minor_fft.fft_minor(
                        xr, xi, stages=True, **kw)}, turns)
        t["torch_fft"] = (chip_smoke._time_ms(lambda: torch.fft.fft(xc)),)
        t["plain"] = (chip_smoke._time_ms(
            lambda: minor_fft.fft_minor_reference(xr, xi, **kw)),)
        t["copy"] = (chip_smoke._time_ms(
            lambda: (yr.copy_(xr), yi.copy_(xi))),)
        bound = 16.0 * rows * n / RATE[0] * 1e3
        _show(f"K1 ({rows}, {n}) c64 {minor_fft.line_split(n)}", t, card,
              f"; bound {bound:.4f} ({16.0 * rows * n / 1e9:.3f} GB); "
              f"line vs stages {err:.3e}")
        out[f"K1 ({rows}, {n})"] = dict(
            {k: v[0] for k, v in t.items()}, bound=bound)
        del xr, xi, xc, yr, yi
    # the Bluestein path at n = 4099 (K1 twice at m = 8320)
    xr, xi = chip_smoke._device_planes((10_000, 4099), seed=4099)
    x = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    t = {"path": (chip_smoke._time_ms(lambda: tpufft_torch.fft(x)),),
         "torch_fft": (chip_smoke._time_ms(lambda: torch.fft.fft(xc)),)}
    _show("Bluestein fft (10000, 4099) c64", t, card)
    out["bluestein"] = {k: v[0] for k, v in t.items()}
    del x, xr, xi, xc
    # K9 (5000 -> 8192) and K20 (5, 16384) beside their stage forms
    xr, xi = chip_smoke._device_planes((10_000, 5000), seed=5000)
    xc = torch.complex(xr, xi)
    kw = dict(n=8192, inverse=False, scale=1.0)
    t = _turns({"line": lambda: minor_fft.fft_minor_padded(xr, xi, **kw),
                "stages": lambda: minor_fft.fft_minor_padded(
                    xr, xi, stages=True, **kw)}, turns)
    t["torch_fft"] = (chip_smoke._time_ms(lambda: torch.fft.fft(xc, n=8192)),)
    bound = 8.0 * 10_000 * (5000 + 8192) / RATE[0] * 1e3
    _show("K9 (10000, 5000 -> 8192) c64", t, card, f"; bound {bound:.4f}")
    out["K9 5000->8192"] = {k: v[0] for k, v in t.items()}
    del xr, xi, xc
    st = torch.randn(5, 2 * 16384, device="cuda")
    kw = dict(inverse=False, scale=1.0)
    t = {"line": (chip_smoke._time_ms(
        lambda: fused_fft.fft_minor_fused(st, **kw)),)}
    _show("K20 (5, 2 x 16384) f32", t, card)
    out["K20 (5, 16384)"] = {k: v[0] for k, v in t.items()}
    return out


def _entry(lib, xr, xi, yr, yi, n):
    fn = lib.tpufft_minor_fft
    fn.argtypes = _build.load().tpufft_minor_fft.argtypes
    fn.restype = ctypes.c_int
    rad = minor_fft.radices(n)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    tw = minor_fft._device_twiddles(n, False, xr.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 tw.data_ptr(), xr.shape[0], n, n, rad_arr, len(rad), 0, 1.0,
                 0, stream)
        assert err == 0, err
    return run


def compare_variants(turns: int, card: str) -> None:
    libs = {k: ctypes.CDLL(v) for k, v in build(variants()).items()}
    tree = _build.load()
    for name, shapes in (("l1", ((10_000, 8320), (10_000, 8192),
                                 (5000, 16384))),
                         ("pair4096", ((40_000, 4096),))):
        for rows, n in shapes:
            xr, xi = chip_smoke._device_planes((rows, n), seed=n)
            ya, yb = torch.empty_like(xr), torch.empty_like(xi)
            za, zb = torch.empty_like(xr), torch.empty_like(xi)
            ref = minor_fft.fft_minor_reference(xr[:64], xi[:64],
                                                inverse=False, scale=1.0)
            run_v = _entry(libs[name], xr, xi, ya, yb, n)
            run_t = _entry(tree, xr, xi, za, zb, n)
            run_v()
            run_t()
            err = max(chip_smoke.pair_err((ya[:64], yb[:64]), ref),
                      chip_smoke.pair_err((za[:64], zb[:64]), ref))
            chip_smoke.check(err < F32_TOL, f"{name} at {n}: {err:.3e}")
            t = _turns({"tree": run_t, name: run_v}, turns)
            if name == "pair4096":
                xc = torch.complex(xr, xi)
                t["torch_fft"] = (chip_smoke._time_ms(
                    lambda: torch.fft.fft(xc)),)
                del xc
            bound = 16.0 * rows * n / RATE[0] * 1e3
            _show(f"variant {name}: K1 ({rows}, {n}) c64", t, card,
                  f"; bound {bound:.4f}; vs plain {err:.3e}")
            del xr, xi, ya, yb, za, zb


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    chip_smoke.phase_device()
    card = chip_smoke._smi("name,power.limit")
    chip_smoke.phase_build()
    RATE[0] = chip_smoke._copy_rate()
    if args.check:
        check()
    if args.times:
        print(json.dumps(times(args.turns, card)))
    if args.variants:
        compare_variants(args.turns, card)


if __name__ == "__main__":
    main()
