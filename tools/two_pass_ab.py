"""The two-pass split on the card: its route (K3 with the twiddle and the
swapped store, then K2) against the three-step it replaced, each pass
alone, cuFFT and the copy floor; the split sweep; patched copies of the
swapped store; and the parent checkout's path, each in turns.

    python3 tools/two_pass_ab.py [--turns N] [--check] [--sweep]
                                 [--variants [NAME ...]]
                                 [--parent OLD_ROOT]

Every time is the median of 20 CUDA-event timings after two warm-up calls,
in ms, printed with the card's name and power limit. Rows, at each shape of
``SHAPES`` ((16, 2**20) and (4, 2**24), c64 planes, the split the tree's
``execute._split_large`` gives):

- ``route``: ``tpufft_torch.fft`` (the tree's route); ``three_step``: the
  route it replaced, ``execute._fft_axis_two_pass(..., _three_step=True)``
  (K3 with the twiddle in the natural order, K1, one transpose copy);
- ``pass1``: K3 with the twiddle and the swapped store alone on the
  (pre a, b, 1) view; ``pass1_natural``: the same in the natural order;
  ``pass2``: K2 on the swapped (pre, b, a) planes; ``k1``: the three-step's
  K1 on (pre a, b); ``swap_copy``: its transpose copy;
- ``cufft``: ``torch.fft.fft`` of the c64 rows; ``floor``: one read and one
  write of the planes at the measured copy rate, twice (two passes).

``--check`` holds each pass and the route against its plain version or
``np.fft`` first. ``--sweep`` times ``_fft_axis_two_pass`` at every split
of ``SPLITS`` (a x b: pass 1 over a, pass 2 over b), in turns, each
checked against the tree's route on the same input. ``--variants
[NAME ...]`` builds patched copies of a header (``VARIANTS``) through
``tools/variant_build.py`` (the other form's sources compiled once and
shared) and times pass 1 of the tree and of each copy in turns at the
restaged shapes of its form, ``RESTAGED`` or ``CLUSTER_RESTAGED`` (each
checked against the plain version): ``direct``, the line form without
the restage (every swapped store straight from registers, lanes on
consecutive columns); ``rows_first``, its units slices first (each batch
row reads the whole twiddle table, the natural store's order) instead of
column groups first; ``cluster_direct``, the cluster form without its
restage over the cluster. ``--parent OLD_ROOT`` (a checkout of the
parent, e.g. ``git archive`` into an ignored directory) times the ``fft``
path of both trees at ``SHAPES`` in subprocesses: old, new, new, old.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import tpufft_torch  # noqa: E402
from tpufft_torch import SplitComplex, execute  # noqa: E402
from tpufft_torch.kernels import inner_fft, minor_fft  # noqa: E402

SHAPES = ((16, 1 << 20), (4, 1 << 24))
# n -> the splits a x b the sweep times, at 2**24 elements (2**26 at
# n = 2**24, the (4, 2**24) path)
SPLITS = {1 << 24: ((4096, 4096), (8192, 2048), (2048, 8192),
                    (16384, 1024), (1024, 16384)),
          1 << 20: ((1024, 1024), (2048, 512), (512, 2048)),
          1 << 15: ((256, 128), (1024, 32), (2048, 16), (512, 64)),
          3 << 14: ((256, 192), (1536, 32), (1024, 48), (2048, 24)),
          1 << 17: ((512, 256), (1024, 128), (2048, 64), (256, 512)),
          1 << 21: ((2048, 1024), (1024, 2048)),
          1 << 22: ((2048, 2048), (1024, 4096), (4096, 1024))}
# pass 1 where the line form restages: (rows, a, b)
RESTAGED = ((16, 1024, 1024), (4, 2048, 8192), (4, 1024, 16384),
            (16, 2048, 512))
F32_TOL = 1e-5
OUT = os.path.join(ROOT, "build", "two_pass_ab")

TIMER = r"""
import statistics, sys, torch
import tpufft_torch
from tpufft_torch import SplitComplex

def median_ms(fn, reps=20):
    fn(); fn(); torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

g = torch.Generator(device="cuda"); g.manual_seed(1)
rows = []
for shape in ((16, 1 << 20), (4, 1 << 24)):
    x = SplitComplex(torch.randn(*shape, generator=g, device="cuda"),
                     torch.randn(*shape, generator=g, device="cuda"))
    rows.append(f"fft{shape} {median_ms(lambda: tpufft_torch.fft(x)):.4f}")
    del x
print(" ".join(rows))
"""


def median_ms(fn, reps: int = 20) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def planes(shape, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda"),
            torch.randn(shape, generator=g, device="cuda"))


def err(got, ref) -> float:
    scale = max(1.0, max(r.abs().max().item() for r in ref))
    return max((g.float() - r.float()).abs().max().item()
               for g, r in zip(got, ref)) / scale


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"two_pass_ab: {what}")


def copy_rate() -> float:
    """Bytes a second of a 1 GiB device-to-device copy (read + write)."""
    src = torch.empty(1 << 28, device="cuda")
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src))
    return 2 * 4 * src.numel() / (ms * 1e-3)


def route_rows(rows: int, n: int, rate: float, do_check: bool) -> dict:
    a, b = execute._split_large(n)
    xr, xi = planes((rows, n), seed=n % 1000)
    x = SplitComplex(xr, xi)
    kw = dict(inverse=False, scale=1.0)
    tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
    v = (rows * a, b, 1)
    r3, i3 = xr.reshape(v), xi.reshape(v)
    sw = inner_fft.fft_inner_nd(r3, i3, n=a, twiddle=tw, swap=True, **kw)
    mid = (rows, b, a)
    s3 = (sw[0].reshape(mid), sw[1].reshape(mid))
    m2 = (rows * a, b)
    calls = {
        "route": lambda: tpufft_torch.fft(x),
        "three_step": lambda: execute._fft_axis_two_pass(
            xr, xi, 1, a, b, _three_step=True, **kw),
        "pass1": lambda: inner_fft.fft_inner_nd(r3, i3, n=a, twiddle=tw,
                                                swap=True, **kw),
        "pass1_natural": lambda: inner_fft.fft_inner_nd(r3, i3, n=a,
                                                        twiddle=tw, **kw),
        "pass2": lambda: inner_fft.fft_inner(*s3, **kw),
        "k1": lambda: minor_fft.fft_minor(xr.reshape(m2), xi.reshape(m2),
                                          **kw),
        "swap_copy": lambda: [t.reshape(rows, a, b).transpose(1, 2)
                              .contiguous() for t in (xr, xi)],
    }
    if do_check:
        for name, plain in (
                ("pass1", lambda: inner_fft.fft_inner_nd_reference(
                    r3, i3, n=a, twiddle=tw, swap=True, **kw)),
                ("pass2", lambda: inner_fft.fft_inner_reference(*s3, **kw))):
            e = err(calls[name](), plain())
            check(e < F32_TOL, f"{name} ({rows}, {n}) vs plain {e:.3e}")
            print(f"  check {name} ({rows}, {n}): vs plain {e:.3e}")
        k = min(rows, 2)
        ref = np.fft.fft(xr[:k].double().cpu().numpy()
                         + 1j * xi[:k].double().cpu().numpy())
        for name in ("route", "three_step"):
            y = calls[name]()
            y = (y.re, y.im) if isinstance(y, SplitComplex) else y
            got = y[0][:k].cpu().numpy() + 1j * y[1][:k].cpu().numpy()
            e = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
            check(e < 1e-4, f"{name} ({rows}, {n}) vs np.fft {e:.3e}")
            print(f"  check {name} ({rows}, {n}): vs np.fft {e:.3e}")
    xc = torch.complex(xr, xi)
    calls["cufft"] = lambda: torch.fft.fft(xc, dim=-1)
    t = {k: median_ms(f) for k, f in calls.items()}
    t["floor"] = 2 * 16.0 * rows * n / rate * 1e3
    print(f"({rows}, {n}) = {a} x {b}, pass 1 "
          f"{inner_fft.form(a, b, torch.float32)} form "
          f"{inner_fft.line_geometry(a, b, torch.float32)}, pass 2 "
          f"{inner_fft.line_geometry(b, a, torch.float32)}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return t


def sweep(turns: int) -> None:
    for n, splits in SPLITS.items():
        rows = max(1, (1 << (26 if n == 1 << 24 else 24)) // n)
        xr, xi = planes((rows, n), seed=7)
        ref = tpufft_torch.fft(SplitComplex(xr, xi))
        ref = (ref.re, ref.im)
        kw = dict(inverse=False, scale=1.0)
        for a, b in splits:
            e = err(execute._fft_axis_two_pass(xr, xi, 1, a, b, **kw), ref)
            check(e < 1e-4, f"split {a} x {b}: vs the route {e:.3e}")
        times = {s: [] for s in splits}
        for _ in range(turns):
            for a, b in splits:
                times[(a, b)].append(median_ms(
                    lambda: execute._fft_axis_two_pass(xr, xi, 1, a, b,
                                                       **kw)))
        print(f"sweep ({rows}, {n}), {turns} turns, ms: " + "; ".join(
            f"{a} x {b} {' / '.join(f'{t:.4f}' for t in ts)}"
            for (a, b), ts in times.items()))
        del xr, xi, ref


# name -> (the patched header, its line, the line's replacement)
VARIANTS = {
    "direct": ("strided_line.cuh", "  constexpr bool kRestage =\n",
               "  constexpr bool kRestage = false &&\n"),
    "rows_first": ("strided_line.cuh",
                   "    unit_at<kSwap>(u, pre, groups, cols_log2, p, c0);\n",
                   "    unit_at<false>(u, pre, groups, cols_log2, p, c0);\n"),
    "cluster_direct": ("strided_long.cuh", "    constexpr bool kRestage =\n",
                       "    constexpr bool kRestage = false &&\n")}
# pass 1 where the cluster form restages: (rows, a, b)
CLUSTER_RESTAGED = ((4, 4096, 4096), (1, 16384, 4096))


def variants(names, turns: int) -> None:
    import ctypes
    import variant_build
    os.chdir(ROOT)
    main = tpufft_torch._build.load()
    libs = {"tree": main}
    for header in ("strided_line.cuh", "strided_long.cuh"):
        with open(os.path.join(ROOT, "tpufft_torch/csrc", header)) as f:
            text = f.read()
        texts = {}
        for name in names:
            head, old, new = VARIANTS[name]
            if head == header:
                check(text.count(old) == 1, f"{name}: the line not found")
                texts[name] = text.replace(old, new)
        if not texts:
            continue
        own = "strided_line" if header == "strided_line.cuh" else \
            "strided_long"
        other = "strided_long" if own == "strided_line" else "strided_line"
        built = variant_build.build(
            os.path.join(OUT, own), header, texts,
            lambda f: f.startswith(("strided_fft", own)) and f.endswith(
                ".cu"),
            shared=lambda f: f.startswith(other) and f.endswith(".cu"))
        for name in texts:
            lib = ctypes.CDLL(built[name][0])
            for fn in ("tpufft_strided_fft_swapped", "tpufft_strided_fft"):
                getattr(lib, fn).argtypes = getattr(main, fn).argtypes
                getattr(lib, fn).restype = getattr(main, fn).restype
            libs[name] = lib

    def with_lib(which, fn):
        saved = inner_fft._build
        inner_fft._build = types.SimpleNamespace(load=lambda: libs[which])
        try:
            return fn()
        finally:
            inner_fft._build = saved

    kw = dict(inverse=False, scale=1.0)
    for shapes, group in ((RESTAGED, "strided_line.cuh"),
                          (CLUSTER_RESTAGED, "strided_long.cuh")):
        keys = ["tree"] + [k for k in libs if k != "tree"
                           and VARIANTS[k][0] == group]
        if len(keys) == 1:
            continue
        for rows, a, b in shapes:
            xr, xi = planes((rows * a, b, 1), seed=a + b)
            tw = execute._device_two_pass_twiddle(a, b, False, xr.device)

            def call():
                return inner_fft.fft_inner_nd(xr, xi, n=a, twiddle=tw,
                                              swap=True, **kw)

            ref = inner_fft.fft_inner_nd_reference(xr, xi, n=a, twiddle=tw,
                                                   swap=True, **kw)
            times = {k: [] for k in keys}
            for k in keys:
                e = err(with_lib(k, call), ref)
                check(e < F32_TOL, f"pass 1 {k} ({rows * a}, {b}) n={a}: "
                      f"{e:.3e}")
            for _ in range(turns):
                for k in keys:
                    times[k].append(with_lib(k, lambda: median_ms(call)))
            print(f"pass 1 ({rows * a}, {b}, 1), n = {a}, swapped store: "
                  + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in ts)}"
                              for k, ts in times.items()))
            del xr, xi, ref


def parent(old: str, turns: int) -> None:
    for label, root in (("old", old), ("new", ROOT), ("new", ROOT),
                        ("old", old)) * turns:
        out = subprocess.run([sys.executable, "-c", TIMER], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root),
                             capture_output=True, text=True, timeout=1800)
        check(out.returncode == 0, f"{label} timer failed:\n{out.stderr}")
        print(f"{label} ({root}): {out.stdout.strip()}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", metavar="OLD_ROOT")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--check", action="store_true")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--variants", nargs="*", choices=sorted(VARIANTS),
                   help="the copies to build and time (all without names)")
    args = p.parse_args()
    check(torch.cuda.is_available(), "needs an NVIDIA GPU")
    print(f"card: {card()}")
    rate = copy_rate()
    print(f"copy rate {rate / 1e9:.0f} GB/s")
    for rows, n in SHAPES:
        for _ in range(args.turns):
            route_rows(rows, n, rate, args.check)
        torch.cuda.empty_cache()
    if args.sweep:
        sweep(args.turns)
    if args.variants is not None:
        variants(args.variants or sorted(VARIANTS), args.turns)
    if args.parent:
        parent(os.path.abspath(args.parent), args.turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
