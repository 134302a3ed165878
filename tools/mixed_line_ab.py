"""The mixed-radix line forms of the minor-axis kernel (K1, K9, K20), the
strided kernel (K2, K3, K18, K19) and the real-input kernels (K7 rfft, K8
irfft) on the card: held against their plain versions, then timed beside
their stage forms.

Run from the repository root on a machine with the GPU:

    python3 tools/mixed_line_ab.py [--check] [--times] [--variants]
                                   [--turns N] [--only {all,complex,real}]

``--check`` holds every mixed-radix length of K1's line form
(``minor_fft._MIXED_STEP``) and of the strided line form (n = 15 2^a, 25,
93, 1080, the r = 3 and 5 lengths too) against the plain versions on
ragged batches (f32 1e-5, bf16 8e-3; forward and inverse, scale 1 and
1/n): K1, K20 and K9 (n_in = n - 1 and n / 2 + 1), K2 and K3 with the
(n, M) twiddle, K19; each length printed with its form, and the library's
form held equal to the wrapper's (``minor_fft.launched_geometry``).

With ``--check``, every real length of K7's and K8's mixed-radix line
form (``real_fft._REAL_STEP``'s halves and ``_ODD_LINES``) is held
against ``rfft_minor_reference`` / ``irfft_minor_reference`` on ragged
batches (f32 1e-5, bf16 8e-3; scale 1 and 1/n), with the library's form
held equal to the wrapper's (``real_fft.launched_geometry``).

``--times`` times, by CUDA events (median of 20 after two warm-up calls),
each line form beside its stage form (``stages=True``), ``torch.fft.fft``
and a device copy of the same bytes (the floor), in turns (line, stages,
stages, line, ``--turns`` times): K1 at (1000000, 93), (64000, 480),
(19200, 1080) and (3840, 2160), K2 on (1, 93, 1000000) (T1's
transform-major axis), (100, 640, 480) (a row that must not move: n =
640) and (10, 1920, 1080), and K1 at (100000, 1024). Every line names the
card and its power limit; the last line is a JSON object of the medians.
``chip_smoke.py`` phase 28 takes the same measurements once; this tool
repeats them in turns without the rest of the smoke run. The real rows
(phase 31's kernel shapes, and K8 beside K7 at each): K7 and K8 at
(1000000, 93), (64000, 480), (50000, 1920) and (25000, 7680), each
beside its stage form
(``stages=True``) in turns, ``torch.fft.rfft`` / ``irfft`` and the copy
floor. ``--only`` picks the complex rows, the real rows or both.

``--variants`` builds patched copies of ``csrc/real_fft.cuh`` (with
``real_fft.cu`` and ``real_line_*.cu`` beside it, one ``nvcc`` a source,
all in parallel, into ``build/mixed_line_ab/``) and times K7 and K8 of
each at the real rows in turns with the tree's, through the copies'
``tpufft_rfft`` / ``tpufft_irfft``: the untangle's and the tangle's loops
unrolled by 4; by 8 where a team holds at most 4 rows (m >= 192) and by
4 below; whole there and by 4 below; and whole everywhere (the tree
unrolls K7's whole at m >= 192 and by 4 below, K8's whole where its
lines lie on lane pairs and by 4 elsewhere: ``HalfStep::untangle_unroll``
and ``tangle_unroll``), with ptxas's registers and spills of each copy's
mixed kernels in f32 and bf16.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tools import ptxas_compare, variant_build  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import (  # noqa: E402
    fused_fft, inner_fft, minor_fft, real_fft)

F32_TOL, BF16_TOL = 1e-5, 8e-3
STRIDED_NS = (25, 30, 60, 93, 120, 240, 480, 960, 1080, 1920, 12, 96, 640,
              1536)
K1_SHAPES = ((1_000_000, 93), (64_000, 480), (19_200, 1080), (3840, 2160),
             (100_000, 1024))
K2_SHAPES = ((1, 93, 1_000_000), (100, 640, 480), (10, 1920, 1080))
REAL_NS = (tuple(sorted(2 * m for m in real_fft._REAL_STEP))
           + real_fft._ODD_LINES)
# (rows, n, kernels): K7 and K8, or K7 alone
REAL_SHAPES = ((1_000_000, 93, "K7 K8"), (64_000, 480, "K7 K8"),
               (50_000, 1920, "K7 K8"), (25_000, 7680, "K7 K8"))


def _hold(what, got, ref, dtype):
    err = chip_smoke.pair_err(got, ref)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    chip_smoke.check(err < tol, f"{what}: {err:.3e} >= {tol}")
    return err


def check() -> None:
    for n in sorted(minor_fft._MIXED_STEP):
        lib = minor_fft.launched_geometry(n)
        want = minor_fft.line_geometry(n)
        chip_smoke.check(lib == {"form": "lines", **want},
                         f"K1 n={n}: library {lib}, wrapper {want}")
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = chip_smoke._planes((131, n), dtype, seed=n)
            st = torch.cat([xr, xi], -1).contiguous()
            for inverse, scale in ((False, 1.0), (True, 1.0 / n),
                                   (False, 1.0 / n), (True, 1.0)):
                kw = dict(inverse=inverse, scale=scale)
                e = _hold(f"K1 n={n} {dtype} {kw}",
                          minor_fft.fft_minor(xr, xi, **kw),
                          minor_fft.fft_minor_reference(xr, xi, **kw), dtype)
                out = fused_fft.fft_minor_fused(st, **kw)
                ref = fused_fft.fft_minor_fused_reference(st, **kw)
                e20 = _hold(f"K20 n={n} {dtype} {kw}",
                            (out[:, :n], out[:, n:]),
                            (ref[:, :n], ref[:, n:]), dtype)
                e9 = 0.0
                for n_in in sorted({n - 1, n // 2 + 1}):
                    pr = xr[:, :n_in].contiguous()
                    pi = xi[:, :n_in].contiguous()
                    e9 = max(e9, _hold(
                        f"K9 {n_in}->{n} {dtype} {kw}",
                        minor_fft.fft_minor_padded(pr, pi, n=n, **kw),
                        minor_fft.fft_minor_padded_reference(pr, pi, n=n,
                                                             **kw), dtype))
                key = str(dtype).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), e, e20, e9)
        torch.cuda.synchronize()
        print(f"  K1/K20/K9 n={n} ({minor_fft.form(n)} form, "
              f"{minor_fft.line_split(n)}): max normalized error {worst}")
    for n in STRIDED_NS:
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            for pre, post in ((3, 241), (2, 40)):
                xr, xi = chip_smoke._planes((pre, n, post), dtype, seed=n)
                tw = chip_smoke._twiddle(n, post, seed=n)
                v = (pre * n, post, 1)
                for inverse, scale in ((False, 1.0), (True, 1.0 / n)):
                    kw = dict(inverse=inverse, scale=scale)
                    e2 = _hold(f"K2 n={n} {(pre, n, post)} {dtype} {kw}",
                               inner_fft.fft_inner(xr, xi, **kw),
                               inner_fft.fft_inner_reference(xr, xi, **kw),
                               dtype)
                    e3 = _hold(
                        f"K3 n={n} {dtype} {kw}",
                        inner_fft.fft_inner_nd(xr.reshape(v), xi.reshape(v),
                                               n=n, twiddle=tw, **kw),
                        inner_fft.fft_inner_nd_reference(
                            xr.reshape(v), xi.reshape(v), n=n, twiddle=tw,
                            **kw), dtype)
                    st = torch.cat([xr, xi], -1).reshape(
                        pre, n, 1, 2 * post).contiguous()
                    got = fused_fft.fft_inner_fused(st, **kw)
                    ref = fused_fft.fft_inner_fused_reference(st, **kw)
                    e19 = _hold(f"K19 n={n} {dtype} {kw}",
                                (got[..., :post], got[..., post:]),
                                (ref[..., :post], ref[..., post:]), dtype)
                    key = str(dtype).split(".")[-1]
                    worst[key] = max(worst.get(key, 0.0), e2, e3, e19)
        torch.cuda.synchronize()
        print(f"  strided n={n}: f32 {inner_fft.form(n, 241, torch.float32)}"
              f" {inner_fft.line_geometry(n, 241, torch.float32)}, bf16 "
              f"{inner_fft.form(n, 241, torch.bfloat16)}; max normalized "
              f"error {worst}")


def check_real() -> None:
    for n in REAL_NS:
        lib = real_fft.launched_geometry(n)
        want = real_fft.line_geometry(n)
        chip_smoke.check(lib == {"form": "lines", **want},
                         f"K7/K8 n={n}: library {lib}, wrapper {want}")
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            for batch in (131, 1, 7):
                x = chip_smoke._planes((batch, n), dtype, seed=n)[0]
                hr, hi = chip_smoke._planes((batch, n // 2 + 1), dtype,
                                            seed=n + 1)
                for scale in (1.0, 1.0 / n):
                    e7 = _hold(f"K7 n={n} ({batch}) {dtype} {scale}",
                               real_fft.rfft_minor(x, scale=scale),
                               real_fft.rfft_minor_reference(x, scale=scale),
                               dtype)
                    y = real_fft.irfft_minor(hr, hi, n=n, scale=scale)
                    ref = real_fft.irfft_minor_reference(hr, hi, n=n,
                                                         scale=scale)
                    e8 = _hold(f"K8 n={n} ({batch}) {dtype} {scale}",
                               (y, y), (ref, ref), dtype)
                    key = str(dtype).split(".")[-1]
                    worst[key] = max(worst.get(key, 0.0), e7, e8)
        torch.cuda.synchronize()
        print(f"  K7/K8 n={n} ({real_fft.form(n)} form {want}): max "
              f"normalized error {worst}")


def _turns(fns: dict, turns: int) -> dict:
    """Each callable timed in turns a, b, b, a (``turns`` rounds); the
    median of each one's medians, and its range."""
    got = {k: [] for k in fns}
    keys = list(fns)
    for _ in range(turns):
        for k in keys + keys[::-1]:
            got[k].append(chip_smoke._time_ms(fns[k]))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def _row(label, line, stages, library, copy, turns, card, what):
    err = chip_smoke.pair_err(line(), stages())
    chip_smoke.check(err < F32_TOL, f"{label} line vs stages {err:.3e}")
    t = _turns({"line": line, "stages": stages}, turns)
    t["torch_fft"] = (chip_smoke._time_ms(library),)
    t["copy"] = (chip_smoke._time_ms(copy),)
    print(f"{label} c64 {what} [{card}]: "
          + ", ".join(f"{k} " + "/".join(f"{x:.4f}" for x in v)
                      for k, v in t.items())
          + f"; line vs stages {err:.3e}")
    return {k: v[0] for k, v in t.items()}


def times(turns: int, card: str) -> dict:
    out = {}
    for rows, n in K1_SHAPES:
        xr, xi = chip_smoke._device_planes((rows, n), seed=n)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        out[f"K1 ({rows}, {n})"] = _row(
            f"K1 ({rows}, {n})",
            lambda: minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0),
            lambda: minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0,
                                        stages=True),
            lambda: torch.fft.fft(xc), lambda: (yr.copy_(xr), yi.copy_(xi)),
            turns, card, f"{minor_fft.form(n)} form {minor_fft.line_split(n)}")
        del xr, xi, xc, yr, yi
    for pre, n, post in K2_SHAPES:
        xr, xi = chip_smoke._device_planes((pre, n, post), seed=n)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        out[f"K2 {(pre, n, post)}"] = _row(
            f"K2 {(pre, n, post)}",
            lambda: inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0),
            lambda: inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0,
                                        stages=True),
            lambda: torch.fft.fft(xc, dim=1),
            lambda: (yr.copy_(xr), yi.copy_(xi)), turns, card,
            f"{inner_fft.form(n, post, torch.float32)} form "
            f"{inner_fft.line_geometry(n, post, torch.float32)}")
        del xr, xi, xc, yr, yi
    return out


def real_times(turns: int, card: str) -> dict:
    """K7 and K8 beside their stage forms in turns, with
    ``torch.fft.rfft`` / ``irfft`` and the copy floor of the same bytes."""
    out = {}
    for rows, n, which in REAL_SHAPES:
        x = chip_smoke._planes((rows, n), torch.float32, seed=n)[0]
        hr, hi = real_fft.rfft_minor(x, scale=1.0)
        hc = torch.complex(hr, hi)
        cx = torch.empty_like(x)  # the floor: a copy of the real plane
        geo = real_fft.line_geometry(n)
        what = f"{real_fft.form(n)} form {(geo['n1'], geo['n2'])}"
        if "K7" in which:
            out[f"K7 ({rows}, {n})"] = _row(
                f"K7 ({rows}, {n})",
                lambda: real_fft.rfft_minor(x, scale=1.0),
                lambda: real_fft.rfft_minor(x, scale=1.0, stages=True),
                lambda: torch.fft.rfft(x), lambda: cx.copy_(x), turns, card,
                what)
        if "K8" in which:
            out[f"K8 ({rows}, {n})"] = _row(
                f"K8 ({rows}, {n})",
                lambda: (lambda y: (y, y))(
                    real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)),
                lambda: (lambda y: (y, y))(
                    real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n,
                                         stages=True)),
                lambda: torch.fft.irfft(hc, n=n), lambda: cx.copy_(x), turns,
                card, what)
        del x, hr, hi, hc, cx
    return out


CSRC = "tpufft_torch/csrc"
VARIANT_DIR = "build/mixed_line_ab"
UNROLL = ("  static constexpr int untangle_unroll = B::rows <= 4 ? iters : 4;\n"
          "  static constexpr int tangle_unroll = B::pair1 || B::pair2 ? iters"
          " : 4;\n")


def _variant_texts() -> dict:
    """real_fft.cuh of each variant: the loops of the untangle (K7) and
    the tangle (K8) both unrolled by 4, by 8 where a team holds at most 4
    rows (by 4 elsewhere), whole there (by 4 elsewhere), or whole
    everywhere."""
    src = open(os.path.join(CSRC, "real_fft.cuh")).read()
    assert src.count(UNROLL) == 1, "marker not unique in real_fft.cuh"
    variants = {"unroll_4": "4", "rows4_8": "B::rows <= 4 ? 8 : 4",
                "rows4_all": "B::rows <= 4 ? iters : 4",
                "unroll_all": "iters"}
    return {name: src.replace(UNROLL,
                              f"  static constexpr int untangle_unroll = "
                              f"{value};\n  static constexpr int "
                              f"tangle_unroll = {value};\n")
            for name, value in variants.items()}


def _build_variants(texts: dict) -> dict:
    """Each variant's header with real_fft.cu and real_line_*.cu beside it,
    one nvcc a source (all at once), linked into one library a variant;
    ptxas's registers and spills of the mixed kernels printed."""
    built = variant_build.build(
        VARIANT_DIR, "real_fft.cuh", texts,
        lambda f: f == "real_fft.cu" or (f.startswith("real_line_")
                                         and f.endswith(".cu")))
    for name, (_, log) in built.items():
        print(f"variant {name}: " + "; ".join(
            f"{ptxas_compare._key(k).replace('tpufft_real::', '')}: {v[0]} "
            f"registers, {v[1]} bytes spill stores"
            for k, v in sorted(ptxas_compare._report(log).items())
            if re.search(r"fft_(mixed|odd)_kernel", k)), flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    args = [vp, vp, vp, vp, vp, ctypes.c_longlong, i32, ctypes.POINTER(i32),
            i32, ctypes.c_float, i32, vp]
    lib.tpufft_rfft.argtypes = args
    lib.tpufft_irfft.argtypes = args
    lib.tpufft_rfft.restype = lib.tpufft_irfft.restype = i32
    return lib


def real_variants(turns: int, card: str) -> dict:
    libs = {"tree": _bind(str(_build.build())),
            **{k: _bind(v) for k, v in
               _build_variants(_variant_texts()).items()}}
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for rows, n, which in REAL_SHAPES:
        x = chip_smoke._planes((rows, n), torch.float32, seed=n)[0]
        hr, hi = real_fft.rfft_minor(x, scale=1.0)
        yr, yi = torch.empty_like(hr), torch.empty_like(hi)
        y = torch.empty_like(x)
        fwd = real_fft._launch_args(n, False, x.device)
        inv = real_fft._launch_args(n, True, x.device)
        ref7 = real_fft.rfft_minor(x, scale=1.0)
        ref8 = real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)

        def call(lib, inverse):
            tw, half, rad, ns = inv if inverse else fwd
            if inverse:
                return lambda: lib.tpufft_irfft(
                    hr.data_ptr(), hi.data_ptr(), y.data_ptr(),
                    tw.data_ptr(), half.data_ptr(), rows, n, rad, ns,
                    1.0 / n, 0, stream)
            return lambda: lib.tpufft_rfft(
                x.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw.data_ptr(),
                half.data_ptr(), rows, n, rad, ns, 1.0, 0, stream)

        for kernel in which.split():
            inverse = kernel == "K8"
            for name, lib in libs.items():
                chip_smoke.check(call(lib, inverse)() == 0,
                                 f"{name} {kernel} launch")
                err = (chip_smoke.norm_err(y, ref8) if inverse else
                       chip_smoke.pair_err((yr, yi), ref7))
                chip_smoke.check(err < F32_TOL,
                                 f"{name} {kernel} n={n}: {err:.3e}")
            t = _turns({k: call(v, inverse) for k, v in libs.items()}, turns)
            print(f"variants {kernel} ({rows}, {n}) f32 [{card}]: " + ", ".join(
                f"{k} " + "/".join(f"{x:.4f}" for x in v)
                for k, v in t.items()), flush=True)
            out[f"{kernel} ({rows}, {n})"] = {k: v[0] for k, v in t.items()}
        del x, hr, hi, yr, yi, y
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", choices=("all", "complex", "real"),
                    default="all")
    args = ap.parse_args()
    chip_smoke.phase_device()
    card = chip_smoke._smi("name,power.limit")
    chip_smoke.phase_build()
    complex_rows = args.only in ("all", "complex")
    real_rows = args.only in ("all", "real")
    if args.check and complex_rows:
        check()
    if args.check and real_rows:
        check_real()
    if args.times:
        out = {}
        if complex_rows:
            out.update(times(args.turns, card))
        if real_rows:
            out.update(real_times(args.turns, card))
        print(json.dumps(out))
    if args.variants and real_rows:
        print(json.dumps(real_variants(args.turns, card)))


if __name__ == "__main__":
    main()
