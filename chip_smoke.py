"""Smoke run of tpufft_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

1. the card: ``nvidia-smi``'s name and power limit, and PyTorch's device
   name; no card is an error, never a CPU run;
2. the build of the CUDA sources in ``tpufft_torch/csrc``, one ``nvcc``
   per source, started together (time and ptxas's resource report);
3. the minor-axis kernel against its plain PyTorch version on the card, on a
   ragged batch of 257 rows: every length class of the kernel, forward and
   inverse, scale 1 and 1/n, f32 and bf16 storage;
4. the main path, ``plan_fft`` + ``fft``/``ifft`` on c64 ``SplitComplex``
   planes at (100000, 1024) and (1000000, 93): rows against ``np.fft.fft``,
   the round trip, and the launch counts (the kernel ran, its plain version
   did not);
5. times by CUDA events (median of 20 after warm-up) at both shapes: the
   main path, the kernel, its plain version, ``torch.fft.fft`` (cuFFT, a
   baseline only) and a device copy of both planes (the floor), with the
   kernel held against its plain version at those shapes;
6. the strided-axis kernel (K2 and K3, with and without the (n, M)
   twiddle) and the pair kernel (K4) against their plain versions, on
   ragged pre and post edges: lengths 8 to 16384, pairs (8, 93) to
   (160, 48), both directions, scale 1 and 1/n, f32 and bf16 storage;
7. the new paths at full size, each driven with every count set to 0
   just before it and read just after: ``fft2`` on (100, 640, 480) (K2 +
   K1), ``fftn(axes=(1, 2, 3))`` on (10, 128, 128, 128) (K3 + K4), the
   two-pass ``fft`` on (16, 1048576) (K3 with the twiddle + K1) and
   Bluestein ``fft`` on (10000, 4099) (K1 twice), each against
   ``np.fft`` on a few slices and through the round trip;
8. times at those shapes: the path, each kernel alone at the shape the
   path gives it, its plain version, cuFFT (a baseline only) and a device
   copy of both planes, plus the old movedim route of the strided axis.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import tpufft_torch
from tpufft_torch import _build, execute
from tpufft_torch.convert import split_from_numpy
from tpufft_torch.kernels import inner_fft, minor_fft, pair_fft

F32_TOL = 1e-5   # kernel vs plain version, f32 storage: both compute in f32
BF16_TOL = 8e-3  # bf16 storage: both round to bf16 (2^-8 relative) at the store
NP_TOL = 1e-3    # main path vs np.fft.fft, the check bench.py makes
KERNEL_NS = (8, 93, 127, 128, 256, 960, 1024, 1792, 4096, 16384)
MAIN_SHAPES = ((100_000, 1024), (1_000_000, 93))
REPS = 20
STRIDED_NS = (8, 93, 127, 128, 960, 1024, 4096, 16384)
PAIRS = ((8, 93), (64, 64), (128, 128), (160, 48))
KERNELS = ("minor", "inner", "inner_nd", "pair")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def norm_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max(1, max |ref|), in f32."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, ref.abs().max().item())
    return (got - ref).abs().max().item() / scale


def pair_err(got, ref) -> float:
    return max(norm_err(got[0], ref[0]), norm_err(got[1], ref[1]))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs "
                           "only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the plain version must run in full f32")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.name})")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    re = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    im = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return re.to("cuda", dtype), im.to("cuda", dtype)


def phase_kernel() -> None:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n in KERNEL_NS:
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = _planes((257, n), dtype, seed=n)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n):
                    got = minor_fft.fft_minor(xr, xi, inverse=inverse,
                                              scale=scale)
                    ref = minor_fft.fft_minor_reference(
                        xr, xi, inverse=inverse, scale=scale)
                    check(got[0].dtype == dtype and got[0].shape == (257, n),
                          f"kernel output {got[0].dtype} {got[0].shape}")
                    err = pair_err(got, ref)
                    worst[dtype] = max(worst[dtype], err)
                    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                    check(err < tol,
                          f"kernel vs plain n={n} {dtype} inverse={inverse} "
                          f"scale={scale}: {err:.3e} >= {tol}")
    torch.cuda.synchronize()
    print(f"kernel vs plain, batch 257, n in {KERNEL_NS}: max normalized "
          f"error f32 {worst[torch.float32]:.3e} (tol {F32_TOL}), "
          f"bf16 {worst[torch.bfloat16]:.3e} (tol {BF16_TOL})")


def reset_counts() -> None:
    for m in (minor_fft, inner_fft, pair_fft):
        m.reset_counts()


def counts() -> tuple[dict, int]:
    """Launches per kernel, and plain-version runs on CUDA tensors."""
    return ({"minor": minor_fft.launches, **inner_fft.launches,
             "pair": pair_fft.launches},
            minor_fft.reference_cuda_calls + inner_fft.reference_cuda_calls
            + pair_fft.reference_cuda_calls)


def phase_main_path() -> int:
    total = 0
    for batch, n in MAIN_SHAPES:
        rng = np.random.default_rng(0)
        re = rng.standard_normal((batch, n)).astype(np.float32)
        im = rng.standard_normal((batch, n)).astype(np.float32)
        x = split_from_numpy(re, im, "cuda")
        plan = tpufft_torch.plan_fft((batch, n), torch.complex64, axes=(-1,))
        torch.cuda.synchronize()
        reset_counts()
        y = plan(x)
        y_fn = tpufft_torch.fft(x)
        back = tpufft_torch.ifft(y)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        launches = by_kernel["minor"]
        check(by_kernel == {"minor": 3, "inner": 0, "inner_nd": 0,
                            "pair": 0},
              f"({batch}, {n}): kernel launches {by_kernel}, expected "
              "minor 3 (plan, fft, ifft)")
        check(plain == 0, f"({batch}, {n}): plain version ran {plain} times "
              "on CUDA tensors")
        total += launches
        check(isinstance(y, tpufft_torch.SplitComplex)
              and y.shape == (batch, n) and y.dtype == torch.float32
              and y.re.is_cuda, f"({batch}, {n}): output form {type(y)}")
        check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
              f"({batch}, {n}): non-finite output")
        check(torch.equal(y.re, y_fn.re) and torch.equal(y.im, y_fn.im),
              f"({batch}, {n}): plan(x) and fft(x) differ")
        got = y.re[:4].cpu().numpy() + 1j * y.im[:4].cpu().numpy()
        ref = np.fft.fft(re[:4].astype(np.float64) + 1j * im[:4])
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"({batch}, {n}): vs np.fft.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"({batch}, {n}): ifft(fft(x)) error {rt:.3e}")
        print(f"main path ({batch}, {n}) c64: 4 rows vs np.fft.fft "
              f"{err:.3e}, round trip {rt:.3e}, kernel launches {launches}, "
              f"plain-version CUDA calls {plain}")
        del x, y, y_fn, back
    return total


def _twiddle(n: int, m: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (n, m))
    return torch.from_numpy(np.stack([np.cos(th), np.sin(th)], -1)
                            .astype(np.float32)).to("cuda")


def phase_new_kernels() -> None:
    """K2, K3 (with and without the twiddle) and K4 against their plain
    versions, printing the worst normalized error per kernel and dtype."""
    worst = {(k, d): 0.0 for k in KERNELS[1:]
             for d in (torch.float32, torch.bfloat16)}

    def hold(kernel, dtype, got, ref, what):
        err = pair_err(got, ref)
        worst[(kernel, dtype)] = max(worst[(kernel, dtype)], err)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        check(got[0].dtype == dtype and got[0].shape == ref[0].shape,
              f"{kernel} {what}: output {got[0].dtype} {got[0].shape}")
        check(err < tol, f"{kernel} vs plain {what}: {err:.3e} >= {tol}")

    for n in STRIDED_NS:
        tw_cache = {}
        for dtype in (torch.float32, torch.bfloat16):
            # ragged pre (11 slices against tiles of up to 8 for short n)
            # and ragged post (37 and 300 columns against power-of-two tiles)
            for pre, M, L in ((11, 37, 1), (2, 12, 25)):
                xr, xi = _planes((pre, n, M * L), dtype, seed=n + M)
                tw = tw_cache.setdefault(M, _twiddle(n, M, seed=n))
                v = (pre * n, M, L)
                for inverse in (False, True):
                    for scale in (1.0, 1.0 / n):
                        what = (f"n={n} {(pre, n, M * L)} {dtype} "
                                f"inverse={inverse} scale={scale}")
                        hold("inner", dtype,
                             inner_fft.fft_inner(xr, xi, inverse=inverse,
                                                 scale=scale),
                             inner_fft.fft_inner_reference(
                                 xr, xi, inverse=inverse, scale=scale), what)
                        for twiddle in (None, tw):
                            kw = dict(n=n, inverse=inverse, scale=scale,
                                      twiddle=twiddle)
                            hold("inner_nd", dtype,
                                 inner_fft.fft_inner_nd(
                                     xr.reshape(v), xi.reshape(v), **kw),
                                 inner_fft.fft_inner_nd_reference(
                                     xr.reshape(v), xi.reshape(v), **kw),
                                 f"{what} with_tw={twiddle is not None}")
    for n1, n2 in PAIRS:
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = _planes((13, n1, n2), dtype, seed=n1 * n2)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / (n1 * n2)):
                    hold("pair", dtype,
                         pair_fft.fft_pair(xr, xi, inverse=inverse,
                                           scale=scale),
                         pair_fft.fft_pair_reference(xr, xi, inverse=inverse,
                                                     scale=scale),
                         f"({n1}, {n2}) {dtype} inverse={inverse} "
                         f"scale={scale}")
    torch.cuda.synchronize()
    for k in KERNELS[1:]:
        print(f"{k} vs plain: max normalized error f32 "
              f"{worst[(k, torch.float32)]:.3e} (tol {F32_TOL}), bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {BF16_TOL})")


def _device_planes(shape, seed):
    """f32 planes made on the card from a seeded generator."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda"),
            torch.randn(shape, generator=g, device="cuda"))


# The new paths at full size: name, shape, what runs, and the launches of
# ONE transform per kernel.
NEW_PATHS = (
    ("nd_strided", (100, 640, 480),
     lambda x, inv: (tpufft_torch.ifft2 if inv else tpufft_torch.fft2)(x),
     {"inner": 1, "minor": 1}),
    ("nd_pair", (10, 128, 128, 128),
     lambda x, inv: (tpufft_torch.ifftn if inv else tpufft_torch.fftn)(
         x, axes=(1, 2, 3)),
     {"inner_nd": 1, "pair": 1}),
    ("two_pass", (16, 1_048_576),
     lambda x, inv: (tpufft_torch.ifft if inv else tpufft_torch.fft)(x),
     {"inner_nd": 1, "minor": 1}),
    ("bluestein", (10_000, 4099),
     lambda x, inv: (tpufft_torch.ifft if inv else tpufft_torch.fft)(x),
     {"minor": 2}),
)


def _np_ref(name, xr, xi):
    """np.fft on the first slices of the path's input, in float64."""
    k = 2 if name != "bluestein" else 4
    x = (xr[:k].cpu().numpy().astype(np.float64)
         + 1j * xi[:k].cpu().numpy())
    if name == "nd_strided":
        return np.fft.fft2(x)
    if name == "nd_pair":
        return np.fft.fftn(x, axes=(1, 2, 3))
    return np.fft.fft(x)


def phase_new_paths() -> dict:
    """Each new path once forward and once back, with every count set to 0
    just before and read just after; returns the launches per kernel."""
    total = dict.fromkeys(KERNELS, 0)
    for name, shape, run, per_call in NEW_PATHS:
        xr, xi = _device_planes(shape, seed=len(name))
        x = tpufft_torch.SplitComplex(xr, xi)
        torch.cuda.synchronize()
        reset_counts()
        y = run(x, False)
        back = run(y, True)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        want = {k: 2 * per_call.get(k, 0) for k in KERNELS}
        check(by_kernel == want,
              f"{name}: kernel launches {by_kernel}, expected {want}")
        check(plain == 0,
              f"{name}: plain versions ran {plain} times on CUDA tensors")
        for k in KERNELS:
            total[k] += by_kernel[k]
        check(y.shape == shape and y.dtype == torch.float32 and y.re.is_cuda,
              f"{name}: output {y.shape} {y.dtype}")
        check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
              f"{name}: non-finite output")
        ref = _np_ref(name, xr, xi)
        k = ref.shape[0]
        got = y.re[:k].cpu().numpy() + 1j * y.im[:k].cpu().numpy()
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"{name}: vs np.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"{name}: round trip error {rt:.3e}")
        print(f"path {name} {shape} c64: {k} slices vs np.fft {err:.3e}, "
              f"round trip {rt:.3e}, launches {by_kernel}, plain-version "
              f"CUDA calls {plain}")
        del x, y, back, xr, xi
    return total


def _movedim_route(xr, xi):
    """PR 1's route for a strided axis 1 of (pre, n, post) planes, the
    baseline the strided kernel replaces: move the axis minor (a copy),
    K1, and move it back (a copy)."""
    pre, n, post = xr.shape
    yr, yi = minor_fft.fft_minor(
        xr.transpose(1, 2).reshape(-1, n).contiguous(),
        xi.transpose(1, 2).reshape(-1, n).contiguous(),
        inverse=False, scale=1.0)
    return (yr.reshape(pre, post, n).transpose(1, 2).contiguous(),
            yi.reshape(pre, post, n).transpose(1, 2).contiguous())


def _pass_gb(shape) -> float:
    return 2 * 2 * 4 * float(np.prod(shape)) / 1e9   # planes in + out, f32


def phase_new_times() -> dict:
    """Times at the new paths' shapes; returns, per kernel, its time and
    its plain version's at the shape timed for the JSON line, and the
    largest absolute error against the plain version at full size."""
    out = {}

    def kernel_row(key, shape, kernel, plain, gb):
        got, ref = kernel(), plain()
        abs_err = max((got[0] - ref[0]).abs().max().item(),
                      (got[1] - ref[1]).abs().max().item())
        err = pair_err(got, ref)
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p = _time_ms(kernel), _time_ms(plain)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({gb / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} ms; vs plain "
              f"max abs {abs_err:.3e}, normalized {err:.3e}")
        row = out.setdefault(key, {"ms": t_k, "plain_ms": t_p,
                                   "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        return t_k

    for name, shape, run, _ in NEW_PATHS:
        xr, xi = _device_planes(shape, seed=1)
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        gb = _pass_gb(shape)

        def copy():
            yr.copy_(xr)
            yi.copy_(xi)

        if name == "nd_strided":
            cufft = lambda: torch.fft.fft2(xc)  # noqa: E731
        elif name == "nd_pair":
            cufft = lambda: torch.fft.fftn(xc, dim=(1, 2, 3))  # noqa: E731
        else:
            cufft = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
        t = {"path": _time_ms(lambda: run(x, False)),
             "torch_fft": _time_ms(cufft), "copy": _time_ms(copy)}
        print(f"times {name} {shape} c64, median of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; one pass {gb:.4f} GB, copy "
              f"{gb / (t['copy'] * 1e-3):.0f} GB/s")
        del xc
        if name == "nd_strided":
            pre, n, post = shape
            kernel_row("inner", shape,
                       lambda: inner_fft.fft_inner(xr, xi, inverse=False,
                                                   scale=1.0),
                       lambda: inner_fft.fft_inner_reference(
                           xr, xi, inverse=False, scale=1.0), gb)
            moved = _time_ms(lambda: _movedim_route(xr, xi))
            print(f"  movedim route of axis 1 {shape} (copy, K1, copy "
                  f"back): {moved:.4f} ms")
            r2, i2 = xr.reshape(-1, post), xi.reshape(-1, post)
            kernel_row("minor", (pre * n, post),
                       lambda: minor_fft.fft_minor(r2, i2, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           r2, i2, inverse=False, scale=1.0), gb)
        elif name == "nd_pair":
            pre, n1, n2, n3 = shape
            v = (pre * n1, n2, n3)
            r3, i3 = xr.reshape(v), xi.reshape(v)
            kernel_row("inner_nd", v,
                       lambda: inner_fft.fft_inner_nd(
                           r3, i3, n=n1, inverse=False, scale=1.0),
                       lambda: inner_fft.fft_inner_nd_reference(
                           r3, i3, n=n1, inverse=False, scale=1.0), gb)
            kernel_row("pair", v,
                       lambda: pair_fft.fft_pair(r3, i3, inverse=False,
                                                 scale=1.0),
                       lambda: pair_fft.fft_pair_reference(
                           r3, i3, inverse=False, scale=1.0), gb)
        elif name == "two_pass":
            rows, n = shape
            a, b = execute._split_large(n)
            v = (rows * a, b, 1)
            r3, i3 = xr.reshape(v), xi.reshape(v)
            tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
            print(f"  split {n} = {a} * {b}")
            kernel_row("inner_nd_tw", v,
                       lambda: inner_fft.fft_inner_nd(
                           r3, i3, n=a, inverse=False, scale=1.0,
                           twiddle=tw),
                       lambda: inner_fft.fft_inner_nd_reference(
                           r3, i3, n=a, inverse=False, scale=1.0,
                           twiddle=tw), gb)
            r2, i2 = xr.reshape(rows * a, b), xi.reshape(rows * a, b)
            kernel_row("minor", (rows * a, b),
                       lambda: minor_fft.fft_minor(r2, i2, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           r2, i2, inverse=False, scale=1.0), gb)
            swap = _time_ms(lambda: [
                t.reshape(rows, a, b).transpose(1, 2).contiguous()
                for t in (xr, xi)])
            print(f"  digit swap copy: {swap:.4f} ms")
        else:
            rows, n = shape
            m = tpufft_torch.next_fast_len(2 * n - 1, aligned=True)
            pr, pi = _device_planes((rows, m), seed=2)
            kernel_row("minor", (rows, m),
                       lambda: minor_fft.fft_minor(pr, pi, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           pr, pi, inverse=False, scale=1.0),
                       _pass_gb((rows, m)))
            del pr, pi
        del x, xr, xi, yr, yi
        torch.cuda.synchronize()
    return out


def _time_ms(fn) -> float:
    """Median of REPS CUDA-event timings after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times() -> dict:
    rows = {}
    for batch, n in MAIN_SHAPES:
        xr, xi = _planes((batch, n), torch.float32, seed=1)
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        plan = tpufft_torch.plan_fft((batch, n), torch.complex64, axes=(-1,))

        got = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
        ref = minor_fft.fft_minor_reference(xr, xi, inverse=False, scale=1.0)
        abs_err = max((got[0] - ref[0]).abs().max().item(),
                      (got[1] - ref[1]).abs().max().item())
        err = pair_err(got, ref)
        check(err < F32_TOL, f"({batch}, {n}): kernel vs plain {err:.3e}")
        del got, ref

        def copy():
            yr.copy_(xr)
            yi.copy_(xi)

        t = {
            "main_path": _time_ms(lambda: plan(x)),
            "kernel": _time_ms(lambda: minor_fft.fft_minor(
                xr, xi, inverse=False, scale=1.0)),
            "plain": _time_ms(lambda: minor_fft.fft_minor_reference(
                xr, xi, inverse=False, scale=1.0)),
            "torch_fft": _time_ms(lambda: torch.fft.fft(xc, dim=-1)),
            "copy": _time_ms(copy),
        }
        gbytes = 2 * 2 * 4 * batch * n / 1e9   # planes in + out, f32
        print(f"times ({batch}, {n}) c64, median of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; kernel {gbytes / (t['kernel'] * 1e-3):.0f} GB/s, "
              f"copy {gbytes / (t['copy'] * 1e-3):.0f} GB/s; kernel vs plain "
              f"max abs {abs_err:.3e}, normalized {err:.3e}")
        rows[(batch, n)] = dict(t, max_abs_err=abs_err)
        del x, xc, xr, xi, yr, yi
    torch.cuda.synchronize()
    return rows


def main() -> None:
    name = phase_device()
    phase_build()
    phase_kernel()
    launches = phase_main_path()
    rows = phase_times()
    phase_new_kernels()
    path_launches = phase_new_paths()
    new_rows = phase_new_times()
    head = rows[MAIN_SHAPES[0]]
    entries = [{
        "name": "minor_fft",
        "route": "cuda",
        "source": "tpufft_torch/csrc/minor_fft.cu",
        "replaces": "tpufft/kernels/mxu_fft.py:1282",
        "launches": launches + path_launches["minor"],
        "max_abs_err": max([r["max_abs_err"] for r in rows.values()]
                           + [new_rows["minor"]["max_abs_err"]]),
        "ms": head["kernel"],
        "plain_ms": head["plain"],
    }]
    for key, name_, line, timed in (
            ("inner", "inner_fft (K2)", 1341, "inner"),
            ("inner_nd", "inner_nd_fft (K3)", 1427, "inner_nd"),
            ("pair", "pair_fft (K4)", 1686, "pair")):
        errs = [new_rows[timed]["max_abs_err"]]
        if key == "inner_nd":
            errs.append(new_rows["inner_nd_tw"]["max_abs_err"])
        entries.append({
            "name": name_,
            "route": "cuda",
            "source": ("tpufft_torch/csrc/pair_fft.cu" if key == "pair"
                       else "tpufft_torch/csrc/strided_fft.cu"),
            "replaces": f"tpufft/kernels/mxu_fft.py:{line}",
            "launches": path_launches[key],
            "max_abs_err": max(errs),
            "ms": new_rows[timed]["ms"],
            "plain_ms": new_rows[timed]["plain_ms"],
        })
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never ran on the main paths")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
