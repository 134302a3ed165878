"""Where the time of K13 (the overlapped-frame STFT) goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/stft_phases.py

It compiles patched copies of ``tpufft_torch/csrc/stft_mm.cu`` into
``build/stft_phases/`` (one ``nvcc`` each, in parallel), each with some
phases switched off, and times ``tpufft_stft_frames`` on the ``stft``
path's shape, (64, 1048832) f32 at nperseg 256, hop 128 (CUDA events,
median of 20; the results of the patched copies are wrong by design):

- ``full``: the kernel as it is;
- ``no_store``: the bins computed but not stored;
- ``no_stages``: the FFT stages skipped;
- ``copy_and_store``: the stages, the detrend and the fill skipped: the
  span copies, the untangle and the stores alone;
- ``k1_units``: the kernel with K1's packing of its stage length for the
  frames a block (~4096 values, 512 threads, two blocks an SM), twice the
  kernel's.

Then it times ``torch.stft(center=False)`` on the same signal and a
device copy of the kernel's bytes. Every line names the card and its power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import minor_fft, real_fft  # noqa: E402

SRC = "tpufft_torch/csrc/stft_mm.cu"
OUT = "build/stft_phases"
STAGES = "  tpufft_fft::run_stages<kPer>(buf, tw, plan, frames, false);\n"
DETREND = "  if (detrend) {\n"
FILL = "    if (e < total) {\n"
UNITS = "  int frames = g.rows > 1 ? g.rows / 2 : 1;\n"
STORE = ("    yr[out0 + e] = X.x * c_r - X.y * c_i;\n"
         "    yi[out0 + e] = X.x * c_i + X.y * c_r;\n")


def variants() -> dict:
    src = open(SRC).read()
    for mark in (STAGES, DETREND, FILL, STORE, UNITS):
        assert src.count(mark) == 1, f"marker not unique in {SRC}: {mark!r}"
    no_stages = src.replace(STAGES, "  __syncthreads();\n")
    # a store that never happens keeps the bins' arithmetic alive
    no_store = src.replace(STORE, "    if (X.x == 1.2345e-30f) {\n"
                           + STORE + "    }\n")
    bare = no_stages.replace(DETREND, "  if (false) {\n").replace(
        FILL, "    if (false) {\n")
    k1_units = src.replace(UNITS, "  int frames = g.rows;\n")
    return {"full": src, "no_store": no_store, "no_stages": no_stages,
            "copy_and_store": bare, "k1_units": k1_units}


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS[:-2], "-shared",
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
    return libs


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
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.tpufft_stft_frames.argtypes = [vp] * 8 + [
            i64, i64, i32, i32, i32, i32, i32, ctypes.POINTER(i32), i32, i32,
            vp]

        def k13():
            err = lib.tpufft_stft_frames(
                x.data_ptr(), win.data_ptr(), cr.data_ptr(), ci.data_ptr(),
                yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), half.data_ptr(),
                batch, n_sig, hop, nseg, nperseg, nperseg, 0, rad, nstages, 0,
                stream)
            assert err == 0, err

        ms = t(k13)
        print(f"{card}: {name}: {ms:.4f} ms "
              f"({nbytes / 1e9 / (ms * 1e-3):.0f} GB/s of the full kernel's "
              f"bytes)", flush=True)
    ts = t(lambda: torch.stft(x, nperseg, hop, window=win, center=False,
                              return_complex=True))
    print(f"{card}: torch.stft(center=False) {ts:.4f} ms; copy of "
          f"{nbytes / 1e6:.1f} MB {chip_smoke._copy_floor_ms(nbytes):.4f} ms")


if __name__ == "__main__":
    main()
