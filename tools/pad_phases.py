"""Where the time of K9's line form (the zero-padded minor-axis FFT) goes,
on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/pad_phases.py

It compiles patched copies of ``tpufft_torch/csrc/minor_fft.cu`` (with its
``minor_fft.cuh``) into ``build/pad_phases/`` (one ``nvcc`` each, in
parallel) and times ``tpufft_minor_fft`` on (rows, n_in) c64 planes
zero-padded to n at the paths' shapes, (1000000, 93 -> 128), (100000,
1024 -> 2048) and (10000, 2047 -> 4096) (CUDA events, median of 20, one
launch an event pair and, beside it, ten back-to-back launches an event
pair; the results of the patched copies that skip work are wrong by
design):

- ``full``: the kernel as it is;
- ``no_pass1``: pass 1's butterflies skipped (the lane kernel's line_dft
  on the loaded columns): the most that skipping the
  butterflies on the pad's known zeros could save;
- ``one_block``: the 256-thread lane kernel (n = 4096) bound to one block
  an SM (up to 255 registers) instead of two (128, with spills).

Then, with the kernel as it is: K9 at (1000000, 96 -> 128) and (1000000,
64 -> 128), whose rows start on 128-byte boundaries (the cost of the odd
row stride at 93 is the difference, per byte), K1 at n on the rows
zero-padded in device memory (the same transform without the pad in the
load), the stage form (``tpufft_minor_fft_stages``),
``torch.fft.fft(x, n)`` and a device copy of the kernel's bytes. Every line
names the card and its power limit.
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
from tpufft_torch.kernels import minor_fft  # noqa: E402

SRC_DIR = "tpufft_torch/csrc"
OUT = "build/pad_phases"
SHAPES = ((1_000_000, 93, 128), (100_000, 1024, 2048), (10_000, 2047, 4096))
PASS1 = "          line_dft<N1, n / N1>(v[s], p, table, inv);\n"
BOUND = ("  return threads == 128 ? 5 : 2;\n")


def variants() -> dict:
    cuh = open(os.path.join(SRC_DIR, "minor_fft.cuh")).read()
    for mark in (PASS1, BOUND):
        assert cuh.count(mark) == 1, f"marker not unique: {mark!r}"
    return {"full": cuh,
            # a butterfly that never runs keeps the loads alive
            "no_pass1": cuh.replace(
                PASS1, "          if (v[s][0].x == 1.2345e-30f)\n  " + PASS1),
            "one_block": cuh.replace(BOUND, BOUND.replace(": 2", ": 1"))}


def build(texts: dict) -> dict:
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        out = os.path.join(OUT, name)
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(SRC_DIR):
            if f.endswith((".cuh", ".cu")) and f != "minor_fft.cuh":
                with open(os.path.join(SRC_DIR, f)) as src, \
                        open(os.path.join(out, f), "w") as dst:
                    dst.write(src.read())
        with open(os.path.join(out, "minor_fft.cuh"), "w") as f:
            f.write(text)
        # minor_fft.cu with the mixed-radix family sources it launches
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
               os.path.join(out, "lib.so"), os.path.join(out, "minor_fft.cu"),
               *(os.path.join(out, f) for f in sorted(os.listdir(out))
                 if f.startswith("minor_line_") and f.endswith(".cu"))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
        libs[name] = os.path.abspath(os.path.join(OUT, name, "lib.so"))
        print(f"{name}: ptxas, f32 padded lane kernels: {report(text)}",
              flush=True)
    return libs


def report(text: str) -> str:
    """ptxas's registers and spill stores of each f32 padded lane kernel,
    by its (N1, N2, warps a team, threads a block)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"minor_lane_padded_kernelIf((?:Li\d+E)+)", line)
            name = m and tuple(map(int, re.findall(r"\d+", m.group(1))))
        elif name and "spill stores" in line:
            spills = line.split(", ")[1]
        elif name and "registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append(f"{name} {regs} registers, {spills}")
            name = None
    return "; ".join(out)


def entry(lib, name: str, xr, xi, yr, yi, n: int):
    """One launch of a C entry point of the library on the planes."""
    fn = getattr(lib, name)
    fn.argtypes = _build.load().tpufft_minor_fft.argtypes
    rad = minor_fft.radices(n)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    tw = minor_fft._device_twiddles(n, False, xr.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 tw.data_ptr(), xr.shape[0], n, xr.shape[1], rad_arr,
                 len(rad), 0, 1.0, 0, stream)
        assert err == 0, err
    return run


def line(card, what, fn, nbytes):
    one, many = chip_smoke._time_ms(fn), chip_smoke._back_to_back_ms(fn)
    print(f"{card}: {what}: {one:.4f} ms, back to back {many:.4f} ms "
          f"({nbytes / 1e9 / (many * 1e-3):.0f} GB/s of K9's bytes)",
          flush=True)


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    libs = {k: ctypes.CDLL(v) for k, v in build(variants()).items()}
    main_lib = _build.load()
    for rows, n_in, n in SHAPES:
        xr, xi = chip_smoke._device_planes((rows, n_in), 1)
        yr = torch.empty(rows, n, device="cuda")
        yi = torch.empty_like(yr)
        nbytes = 8 * rows * (n_in + n)
        print(f"{card}: K9 ({rows}, {n_in} -> {n}) c64, "
              f"{minor_fft.form(n, n_in)} form, {nbytes / 1e6:.1f} MB moved",
              flush=True)
        for name, lib in libs.items():
            line(card, name, entry(lib, "tpufft_minor_fft", xr, xi, yr, yi,
                                   n), nbytes)
        line(card, "stage form", entry(main_lib,
                                       "tpufft_minor_fft_stages",
                                       xr, xi, yr, yi, n), nbytes)
        pr = torch.nn.functional.pad(xr, (0, n - n_in))
        pi = torch.nn.functional.pad(xi, (0, n - n_in))
        line(card, f"K1 on rows zero-padded to {n} in memory",
             entry(main_lib, "tpufft_minor_fft", pr, pi, yr, yi, n), nbytes)
        del pr, pi
        if n == 128:
            for other in (96, 64):
                ar, ai = chip_smoke._device_planes((rows, other), 2)
                nb = 8 * rows * (other + n)
                run = entry(main_lib, "tpufft_minor_fft", ar, ai, yr, yi, n)
                one = chip_smoke._back_to_back_ms(run)
                print(f"{card}: K9 ({rows}, {other} -> {n}), rows on "
                      f"128-byte boundaries: back to back {one:.4f} ms "
                      f"({nb / 1e9 / (one * 1e-3):.0f} GB/s)", flush=True)
                del ar, ai
        xc = torch.complex(xr, xi)
        lib_ms = chip_smoke._time_ms(lambda: torch.fft.fft(xc, n=n))
        print(f"{card}: torch.fft.fft(x, n={n}) {lib_ms:.4f} ms; copy of "
              f"{nbytes / 1e6:.1f} MB {chip_smoke._copy_floor_ms(nbytes):.4f}"
              " ms", flush=True)
        del xr, xi, yr, yi, xc


if __name__ == "__main__":
    main()
