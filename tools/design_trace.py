"""Where the time of chip_smoke's phase-25 and phase-26 paths goes, by
torch.profiler.

Run from the repository root on a machine with the GPU:

    python3 tools/design_trace.py

For each path of ``chip_smoke.phase_design_paths`` (``freqz`` of a 101-tap
FIR at worN 2048, of a (129, 16384) bank at worN 1024 and of a (65537,)
FIR at worN 2**20; ``dlsim`` of the 8-state, 4-input system on
(1048576, 4) f32; the linear ``chirp`` and ``gausspulse`` on (64, 1048576)
f32), and for each call of ``chip_smoke.phase_peaks_spline_paths``
(``find_peaks``, ``argrelmax``/``argrelmin``, ``find_peaks_cwt`` and the
B-spline filters at phase 26's sizes) it prints, after a warm-up call:

- the wall time of one call, host clock from a synchronized start to a
  synchronized end, median of 5 (no profiler);
- from one profiled call (CPU and CUDA activities,
  ``chip_smoke._profiled``): the device kernels' summed time, their count,
  the device's idle share of the profiled wall time (1 - kernel time /
  wall time), the host time spent in the call's Python code outside torch
  ops (the profiled call's wall time less the summed self CPU time of its
  torch ops), and the five kernels with the most device time;
- for ``freqz``, the host time of the frequency grid alone, median of 5:
  tpufft's formula (``np.linspace`` then the ``fs`` scaling, two more
  arrays) beside the port's (``design._uniform_grid``, one array scaled
  in place).

The first line names the card and its power limit. Nothing is built but
the library the FFT paths load (``chip_smoke.phase_build``).
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import tpufft_torch  # noqa: E402
from tpufft_torch import design  # noqa: E402

REPS = 5


def _wall_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _host_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _trace(name: str, fn) -> None:
    fn()
    torch.cuda.synchronize()
    wall = _wall_ms(fn)
    prof = chip_smoke._profiled(fn)
    traced = prof["wall_ms"]
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:5]
    print(f"{name}: wall {wall:.3f} ms (median of {REPS}); profiled call "
          f"{traced:.3f} ms: {prof['kernels']} kernels, device "
          f"{prof['device_ms']:.3f} ms, idle share "
          f"{1 - prof['device_ms'] / traced:.3f}, torch ops' self CPU "
          f"{prof['op_cpu_ms']:.3f} ms, host outside them "
          f"{max(0.0, traced - prof['op_cpu_ms']):.3f} ms")
    for kname, ms in top:
        print(f"    {ms:.4f} ms  {kname[:110]}")


def main() -> None:
    name, _ = chip_smoke.phase_device()
    chip_smoke.phase_build()
    print(f"card: {name}")
    fir = tpufft_torch.firwin(101, 0.2)
    row = torch.as_tensor(fir, dtype=torch.float32, device="cuda")
    bank = chip_smoke._device_planes(chip_smoke.FREQZ_BANK, seed=71)[0]
    long = chip_smoke._device_planes((chip_smoke.FREQZ_LONG,), seed=72)[0]
    system = chip_smoke._dlsim_system()
    u = chip_smoke._device_planes(chip_smoke.DLSIM_SHAPE, seed=73)[0]
    x0 = np.linspace(-1.0, 1.0, chip_smoke.DLSIM_SYSTEM[0])
    t = chip_smoke._wave_grid()
    paths = (
        ("freqz firwin(101) worN=2048",
         lambda: tpufft_torch.freqz(row, worN=2048), 2048),
        ("freqz bank (129, 16384) worN=1024",
         lambda: tpufft_torch.freqz(bank, worN=1024), 1024),
        ("freqz (65537,) worN=2**20",
         lambda: tpufft_torch.freqz(long, worN=2 ** 20), 2 ** 20),
        ("dlsim (8, 4, 2) u (1048576, 4)",
         lambda: tpufft_torch.dlsim(system, u, x0=x0), None),
        ("chirp linear (64, 1048576)",
         lambda: tpufft_torch.chirp(t, 5.0, 1.0, 20.0), None),
        ("gausspulse retquad retenv (64, 1048576)",
         lambda: tpufft_torch.gausspulse(t - 0.3, fc=50.0, retquad=True,
                                         retenv=True), None),
    )
    for pname, fn, worN in paths:
        _trace(pname, fn)
        if worN is not None:
            old = _host_ms(lambda: np.linspace(0.0, math.pi, worN,
                                               endpoint=False)
                           * (2 * math.pi) / (2 * math.pi))
            new = _host_ms(lambda: design._uniform_grid(worN, math.pi,
                                                        False))
            print(f"    frequency grid on the host: linspace and scaling "
                  f"{old:.3f} ms, _uniform_grid {new:.3f} ms")
    del row, bank, long, u, t
    for pname, fn in chip_smoke._peak_spline_calls(
            chip_smoke._peak_spline_inputs()).items():
        _trace(pname, fn)


if __name__ == "__main__":
    main()
