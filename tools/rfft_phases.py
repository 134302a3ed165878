"""Where the time of K7's line form (the real-input minor-axis FFT) goes, on
the card.

Run from the repository root on a machine with the GPU:

    python3 tools/rfft_phases.py

It compiles patched copies of ``tpufft_torch/csrc/real_fft.cu`` into
``build/rfft_phases/`` (one ``nvcc`` each, in parallel), each with one
part of ``rfft_lane_kernel`` changed, and times ``tpufft_rfft`` at every
length of the line form, (400000, 256) to (12500, 8192) f32 (CUDA events,
median of 20, one launch an event pair and, beside it, ten back-to-back
launches an event pair, which hide the host's time per launch; the results
of the patched copies that skip work are wrong by design):

- ``full``: the kernel as it is;
- ``no_w``: W^k taken as 1 in the untangle, no read of ``half_tw``;
- ``no_store``: the bins computed but not stored;
- ``unroll_1``, ``unroll_4``, ``unroll_all``: the untangle's loop not
  unrolled, unrolled by 4, or unrolled whole, at every geometry (the
  kernel unrolls it whole for teams of one or two warps, by 4 for four);
- ``aligned_rows``: rows stored m bins apart, not m + 1, so that every
  warp's store instruction writes whole 128-byte lines;
- ``ascending``: the bins m - k stored at m/2 + k, so that all four of an
  iteration's store instructions run in ascending order;
- ``four_blocks``: a launch bound of four 128-thread blocks an SM, not
  five (up to 128 registers).

Then ``torch.fft.rfft`` of the same rows and a device copy of the
kernel's bytes. Every line names the card and its power limit.
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
from tpufft_torch.kernels import real_fft  # noqa: E402

SRC = "tpufft_torch/csrc/real_fft.cu"
OUT = "build/rfft_phases"
# every length of the line form, ~100 MB of input each
SHAPES = tuple((102_400_000 // n, n) for n in (256, 512, 1024, 2048, 4096,
                                              8192))
W = "      const float2 wd = cmul(__ldg(&half_tw[k]),\n"
STORE = "      if (row < batch) {\n        const int64_t out = row * (m + 1);\n"
UNROLL = "#pragma unroll (kUnroll)\n"
MIRROR = ("        store_f(yr, out + m - k, hs * (s.x - wd.y));\n"
          "        store_f(yi, out + m - k, -hs * (s.y + wd.x));\n")
BOUND = ("__global__ void __launch_bounds__(kThreads, kLaneMinBlocks(kThreads))"
         "\nrfft_lane_kernel(")


def variants() -> dict:
    src = open(SRC).read()
    for mark in (W, STORE, UNROLL, MIRROR, BOUND):
        assert src.count(mark) == 1, f"marker not unique in {SRC}: {mark!r}"
    # a store that never happens keeps the bins' arithmetic alive
    no_store = src.replace(STORE, STORE.replace(
        "row < batch", "row < batch && s.x == 1.2345e-30f"))
    four = src.replace(BOUND, BOUND.replace("kLaneMinBlocks(kThreads)",
                                            "kThreads == 128 ? 4 : 2"))
    return {"full": src,
            "no_w": src.replace(W, W.replace("__ldg(&half_tw[k])",
                                             "make_float2(1.f, 0.f)")),
            "no_store": no_store,
            "unroll_1": src.replace(UNROLL, "#pragma unroll 1\n"),
            "unroll_4": src.replace(UNROLL, "#pragma unroll 4\n"),
            "unroll_all": src.replace(UNROLL, "#pragma unroll\n"),
            "aligned_rows": src.replace(STORE, STORE.replace(
                "row * (m + 1)", "row * m")),
            "ascending": src.replace(MIRROR, MIRROR.replace(
                "out + m - k", "out + H + k")),
            "four_blocks": four}


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-Itpufft_torch/csrc",
               "-o", os.path.join(OUT, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
        libs[name] = os.path.abspath(os.path.join(OUT, f"{name}.so"))
        print(f"{name}: ptxas, f32 kernels: {report(text)}", flush=True)
    return libs


def report(text: str) -> str:
    """ptxas's registers and spill stores of each f32 line-form kernel, by
    its (N1, N2, warps a team, threads a block)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"rfft_lane_kernelIf((?:Li\d+E)+)", line)
            name = m and tuple(map(int, re.findall(r"\d+", m.group(1))))
        elif name and "spill stores" in line:
            spills = line.split(", ")[1]
        elif name and "registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append(f"{name} {regs} registers, {spills}")
            name = None
    return "; ".join(out)


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    libs = build(variants())
    t = chip_smoke._time_ms
    i32, i64, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for rows, n in SHAPES:
        x, _ = chip_smoke._device_planes((rows, n), 1)
        yr = torch.empty(rows, n // 2 + 1, device="cuda")
        yi = torch.empty_like(yr)
        tw, half, rad, nstages = real_fft._launch_args(n, False, x.device)
        nbytes = 4 * (x.numel() + 2 * yr.numel())
        print(f"{card}: K7 ({rows}, {n}) f32, {real_fft.form(n)} form, "
              f"{nbytes / 1e6:.1f} MB moved", flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.tpufft_rfft.argtypes = [vp] * 5 + [
                i64, i32, ctypes.POINTER(i32), i32, ctypes.c_float, i32, vp]

            def k7():
                err = lib.tpufft_rfft(
                    x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                    tw.data_ptr(), half.data_ptr(), rows, n, rad, nstages,
                    1.0, 0, stream)
                assert err == 0, err

            one, many = t(k7), chip_smoke._back_to_back_ms(k7)
            print(f"{card}: {name}: {one:.4f} ms, back to back {many:.4f} "
                  f"ms ({nbytes / 1e9 / (many * 1e-3):.0f} GB/s of the full "
                  f"kernel's bytes)", flush=True)
        lib_ms = t(lambda: torch.fft.rfft(x))
        lib_many = chip_smoke._back_to_back_ms(lambda: torch.fft.rfft(x))
        print(f"{card}: torch.fft.rfft {lib_ms:.4f} ms, back to back "
              f"{lib_many:.4f} ms; copy of {nbytes / 1e6:.1f} MB "
              f"{chip_smoke._copy_floor_ms(nbytes):.4f} ms", flush=True)
        del x, yr, yi


if __name__ == "__main__":
    main()
