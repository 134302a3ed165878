"""Where the time of K13 (the overlapped-frame STFT) and K15 (the Welch
and CSD sums on the same frame FFT) goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/stft_phases.py

It compiles patched copies of ``tpufft_torch/csrc/stft_mm.cu`` into
``build/stft_phases/`` (one ``nvcc`` each, in parallel), each with some
phases switched off, and times in each ``tpufft_stft_frames`` on the
``stft`` path's shape, (64, 1048832) f32 at nperseg 256, hop 128, and
``tpufft_welch_frames`` on the ``welch`` and ``csd`` paths' shape, (64,
1048576) f32 (two such signals for csd) at nperseg 256, hop 128, constant
detrend (CUDA events, median of 20; the results of the patched copies are
wrong by design):

- ``full``: the kernels as they are;
- ``no_store``: K13's bins computed but not stored (K15 as it is);
- ``no_accumulate``: K15's frame core without its epilogue, the per-bin
  sums over the run's frames (K13 as it is);
- ``no_stages``: the FFT stages skipped (both);
- ``copy_and_epilogue``: the stages, the detrend and the fill skipped:
  the span copies and K13's untangle and stores, or K15's sums, alone;
- ``k1_units``: K13 with K1's packing of its stage length for the frames a
  block (~4096 values, 512 threads, two blocks an SM), twice the kernel's
  (K15 as it is);
- ``k15_units``: K15 with twice its frames a block (~4096 stage values);
- ``k15_run_a_block``: K15 with one block a run of frames (a partial a
  run, as K13's grid), not the fewest blocks a row that fill the card;
- ``k15_256x3``, ``k15_256x2``: K15 under the launch bound (256, 3) or
  (256, 2), up to 80 or 128 registers a thread, where (512, 2) holds it to
  64 (it launches at most 256 threads);
- ``k15_one_group``: K15's epilogue on one group of threads (a thread a
  pair of bins, every frame), not blockDim / units groups each taking
  every groups-th frame.

In ``full`` it also times K15 welch at each detrend kind (none, constant,
linear).

Then it times ``torch.stft(center=False)`` on the same signal and a
device copy of each kernel's bytes. Every line names the card and its
power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import minor_fft, real_fft  # noqa: E402

SRC = "tpufft_torch/csrc/stft_mm.cu"
OUT = "build/stft_phases"
STAGES = ("  tpufft_fft::run_stages<kPer>(buf, tw, plan, kSignals * frames,"
          " false);\n")
DETREND = "  if (detrend) {\n"
FILL = "    if (e < total) {\n"
UNITS = "  int frames = g.rows > 1 ? g.rows / 2 : 1;\n"
STORE = ("    yr[out0 + e] = X.x * c_r - X.y * c_i;\n"
         "    yi[out0 + e] = X.x * c_i + X.y * c_r;\n")
ACCUMULATE = "      for (int r = g; r < here; r += groups) {\n"
K15_UNITS = "  int frames = g.rows > planes ? g.rows / (2 * planes) : 1;\n"
PER_ROW = "  int per_row = 1;\n"
K15_BOUND = "__global__ void __launch_bounds__(kBlock, 2)\nwelch_frames_kernel("
GROUPS = "  return threads / units > 1 ? threads / units : 1;\n"


def variants() -> dict:
    src = open(SRC).read()
    for mark in (STAGES, DETREND, FILL, STORE, UNITS, ACCUMULATE, K15_UNITS,
                 PER_ROW, K15_BOUND, GROUPS):
        assert src.count(mark) == 1, f"marker not unique in {SRC}: {mark!r}"
    no_stages = src.replace(STAGES, "  __syncthreads();\n")
    # a store that never happens keeps the bins' arithmetic alive
    no_store = src.replace(STORE, "    if (X.x == 1.2345e-30f) {\n"
                           + STORE + "    }\n")
    no_accumulate = src.replace(ACCUMULATE,
                                "      for (int r = g; r < 0; r += groups) {\n")
    bare = no_stages.replace(DETREND, "  if (false) {\n").replace(
        FILL, "    if (false) {\n")
    k1_units = src.replace(UNITS, "  int frames = g.rows;\n")
    k15_units = src.replace(
        K15_UNITS, "  int frames = g.rows > planes ? g.rows / planes : 1;\n")
    run_a_block = src.replace(PER_ROW, "  int per_row = p->runs;\n")
    bounds = {f"k15_256x{m}": src.replace(K15_BOUND, K15_BOUND.replace(
        "kBlock, 2", f"256, {m}")) for m in (3, 2)}
    return {"full": src, "no_store": no_store,
            "no_accumulate": no_accumulate, "no_stages": no_stages,
            "copy_and_epilogue": bare, "k1_units": k1_units,
            "k15_units": k15_units, "k15_run_a_block": run_a_block, **bounds,
            "k15_one_group": src.replace(GROUPS, "  return 1;\n")}


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared",
               "-Itpufft_torch/csrc", "-o", os.path.join(OUT, f"{name}.so"),
               cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
        libs[name] = os.path.abspath(os.path.join(OUT, f"{name}.so"))
        print(f"{name}: {_registers(text)}")
    return libs


def _registers(log: str) -> str:
    """ptxas's registers and spill stores of the f32 instantiations of K13
    (stft_frames_kernel) and K15 (welch_frames_kernel), from nvcc's log."""
    out, cur, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"entry function '_ZN3k13\d+(\w+?_kernel)If((?:Lb\dE)+)",
                      line)
        if m:
            flags = ", ".join(re.findall(r"Lb(\d)", m.group(2)))
            cur = f"{m.group(1)}<f32, {flags}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if cur and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out.append(f"{cur} {m.group(1)} registers, {spill} bytes "
                       "spilled")
            cur = None
    return "; ".join(out)


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    libs = build(variants())
    t = chip_smoke._time_ms
    i32, i64, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    batch, n_sig, nperseg, hop = 64, 1048832, 256, 128
    nseg = 1 + (n_sig - nperseg) // hop
    m1 = nperseg // 2 + 1
    x, _ = chip_smoke._device_planes((batch, n_sig), 1)
    yr = torch.empty(batch, nseg, m1, device="cuda")
    yi = torch.empty_like(yr)
    win = torch.hann_window(nperseg, device="cuda")
    cr = torch.full((m1,), 1.0 / win.sum().item(), device="cuda")
    ci = torch.zeros_like(cr)
    tw, half, rad, nstages = real_fft._launch_args(nperseg, False, x.device)
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = 4 * (x.numel() + 2 * yr.numel())
    print(f"{card}: K13 on ({batch}, {n_sig}) f32, nperseg {nperseg}, hop "
          f"{hop}: {nseg} frames a row, {nbytes / 1e6:.1f} MB moved, stage "
          f"radices {minor_fft.radices(nperseg // 2)}")
    # K15 at the welch and csd paths' shape
    n_w = 1048576
    nseg_w = 1 + (n_w - nperseg) // hop
    xw = x[:, :n_w].contiguous()
    yw, _ = chip_smoke._device_planes((batch, n_w), 2)
    outr = torch.empty(batch, m1, device="cuda")
    outi = torch.empty_like(outr)
    w_bytes = {0: 4 * (xw.numel() + outr.numel()),
               1: 4 * (2 * xw.numel() + 2 * outr.numel())}
    print(f"{card}: K15 on ({batch}, {n_w}) f32 (csd: two signals), nperseg "
          f"{nperseg}, hop {hop}, constant detrend: {nseg_w} frames a row, "
          f"{w_bytes[0] / 1e6:.1f} / {w_bytes[1] / 1e6:.1f} MB read")
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.tpufft_stft_frames.argtypes = [vp] * 8 + [
            i64, i64, i32, i32, i32, i32, i32, ctypes.POINTER(i32), i32, i32,
            vp]
        lib.tpufft_welch_partial_floats.argtypes = [i64] + [i32] * 6
        lib.tpufft_welch_partial_floats.restype = i64
        lib.tpufft_welch_frames.argtypes = [vp] * 8 + [
            i64, i64, i32, i32, i32, i32, i32, ctypes.POINTER(i32), i32, i32,
            i32, vp]

        def k13():
            err = lib.tpufft_stft_frames(
                x.data_ptr(), win.data_ptr(), cr.data_ptr(), ci.data_ptr(),
                yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), half.data_ptr(),
                batch, n_sig, hop, nseg, nperseg, nperseg, 0, rad, nstages, 0,
                stream)
            assert err == 0, err

        ms = t(k13)
        print(f"{card}: {name}: K13 {ms:.4f} ms "
              f"({nbytes / 1e9 / (ms * 1e-3):.0f} GB/s of the full kernel's "
              f"bytes)", flush=True)
        for cross in (0, 1):
            floats = lib.tpufft_welch_partial_floats(batch, hop, nseg_w,
                                                     nperseg, nperseg, cross,
                                                     0)
            assert floats > 0, floats
            part = torch.empty(floats, device="cuda")

            def k15(detrend=1):
                err = lib.tpufft_welch_frames(
                    xw.data_ptr(), yw.data_ptr() if cross else None,
                    win.data_ptr(), part.data_ptr(), outr.data_ptr(),
                    outi.data_ptr() if cross else None, tw.data_ptr(),
                    half.data_ptr(), batch, n_w, hop, nseg_w, nperseg,
                    nperseg, detrend, rad, nstages, cross, 0, stream)
                assert err == 0, err

            ms = t(k15)
            rows = floats // (batch * m1 * (1 + cross))
            print(f"{card}: {name}: K15 {('welch', 'csd')[cross]} {ms:.4f} "
                  f"ms ({w_bytes[cross] / 1e9 / (ms * 1e-3):.0f} GB/s of its "
                  f"bytes; {rows} blocks a row)", flush=True)
            if name == "full" and not cross:
                print(f"{card}: {name}: K15 welch by detrend kind (none, "
                      f"constant, linear): " + ", ".join(
                          f"{t(lambda: k15(d)):.4f}" for d in (0, 1, 2))
                      + " ms", flush=True)
    ts = t(lambda: torch.stft(x, nperseg, hop, window=win, center=False,
                              return_complex=True))
    print(f"{card}: torch.stft(center=False) {ts:.4f} ms; copy of "
          f"{nbytes / 1e6:.1f} MB {chip_smoke._copy_floor_ms(nbytes):.4f} ms")
    for cross in (0, 1):
        print(f"{card}: copy of {w_bytes[cross] / 1e6:.1f} MB (K15 "
              f"{('welch', 'csd')[cross]}'s bytes) "
              f"{chip_smoke._copy_floor_ms(w_bytes[cross]):.4f} ms")


if __name__ == "__main__":
    main()
