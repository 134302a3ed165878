"""The mixed-radix line forms of the minor-axis kernel (K1, K9, K20) and the
strided kernel (K2, K3, K18, K19) on the card: held against their plain
versions, then timed beside their stage forms.

Run from the repository root on a machine with the GPU:

    python3 tools/mixed_line_ab.py [--check] [--times] [--turns N]

``--check`` holds every mixed-radix length of K1's line form
(``minor_fft._MIXED_STEP``) and of the strided line form (n = 15 2^a, 25,
93, 1080, the r = 3 and 5 lengths too) against the plain versions on
ragged batches (f32 1e-5, bf16 8e-3; forward and inverse, scale 1 and
1/n): K1, K20 and K9 (n_in = n - 1 and n / 2 + 1), K2 and K3 with the
(n, M) twiddle, K19; each length printed with its form, and the library's
form held equal to the wrapper's (``minor_fft.launched_geometry``).

``--times`` times, by CUDA events (median of 20 after two warm-up calls),
each line form beside its stage form (``stages=True``), ``torch.fft.fft``
and a device copy of the same bytes (the floor), in turns (line, stages,
stages, line, ``--turns`` times): K1 at (1000000, 93), (64000, 480),
(19200, 1080) and (3840, 2160), K2 on (1, 93, 1000000) (T1's
transform-major axis), (100, 640, 480) (a row that must not move: n =
640) and (10, 1920, 1080), and K1 at (100000, 1024). Every line names the
card and its power limit; the last line is a JSON object of the medians.
``chip_smoke.py`` phase 28 takes the same measurements once; this tool
repeats them in turns without the rest of the smoke run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpufft_torch.kernels import fused_fft, inner_fft, minor_fft  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 8e-3
STRIDED_NS = (25, 30, 60, 93, 120, 240, 480, 960, 1080, 1920, 12, 96, 640,
              1536)
K1_SHAPES = ((1_000_000, 93), (64_000, 480), (19_200, 1080), (3840, 2160),
             (100_000, 1024))
K2_SHAPES = ((1, 93, 1_000_000), (100, 640, 480), (10, 1920, 1080))


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    chip_smoke.phase_device()
    card = chip_smoke._smi("name,power.limit")
    chip_smoke.phase_build()
    if args.check:
        check()
    if args.times:
        print(json.dumps(times(args.turns, card)))


if __name__ == "__main__":
    main()
