"""Smoke run of tpufft_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

1. the card: ``nvidia-smi``'s name and power limit, and PyTorch's device
   name; no card is an error, never a CPU run;
2. the build of the CUDA sources in ``tpufft_torch/csrc`` (time and ptxas's
   resource report);
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
   kernel held against its plain version at those shapes.

The line before the last is one JSON object describing the kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import tpufft_torch
from tpufft_torch import _build
from tpufft_torch.convert import split_from_numpy
from tpufft_torch.kernels import minor_fft

F32_TOL = 1e-5   # kernel vs plain version, f32 storage: both compute in f32
BF16_TOL = 8e-3  # bf16 storage: both round to bf16 (2^-8 relative) at the store
NP_TOL = 1e-3    # main path vs np.fft.fft, the check bench.py makes
KERNEL_NS = (8, 93, 127, 128, 256, 960, 1024, 1792, 4096, 16384)
MAIN_SHAPES = ((100_000, 1024), (1_000_000, 93))
REPS = 20


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


def phase_main_path() -> int:
    total = 0
    for batch, n in MAIN_SHAPES:
        rng = np.random.default_rng(0)
        re = rng.standard_normal((batch, n)).astype(np.float32)
        im = rng.standard_normal((batch, n)).astype(np.float32)
        x = split_from_numpy(re, im, "cuda")
        plan = tpufft_torch.plan_fft((batch, n), torch.complex64, axes=(-1,))
        torch.cuda.synchronize()
        minor_fft.reset_counts()
        y = plan(x)
        y_fn = tpufft_torch.fft(x)
        back = tpufft_torch.ifft(y)
        torch.cuda.synchronize()
        launches, plain = minor_fft.launches, minor_fft.reference_cuda_calls
        check(launches == 3, f"({batch}, {n}): kernel launches {launches}, "
              "expected 3 (plan, fft, ifft)")
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
    head = rows[MAIN_SHAPES[0]]
    print(json.dumps({"kernels": [{
        "name": "minor_fft",
        "route": "cuda",
        "source": "tpufft_torch/csrc/minor_fft.cu",
        "replaces": "tpufft/kernels/mxu_fft.py:1282",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": head["kernel"],
        "plain_ms": head["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
