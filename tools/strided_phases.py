"""Where the registers and the time of the strided kernel's line form go,
on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/strided_phases.py

It compiles patched copies of the strided kernel's sources
(``tpufft_torch/csrc/strided_fft.cu``, ``strided_line.cuh`` and the
power-of-two and radix-5 instantiations; the radix-3 launcher is a stub)
into ``build/strided_phases/<variant>/`` (one ``nvcc`` a source, all in
parallel), prints ptxas's registers and spills of each f32 split-plane
line-form kernel, and times each variant's ``tpufft_strided_fft`` in the
geometry that variant's launch takes (``tpufft_strided_line_geometry``)
at the paths' shapes (CUDA events, median of 20):

- ``full``: the kernel as it is (a launch bound of two 320-lane blocks
  an SM, 96 registers, or one 512-lane block at the longest lines; the
  rounds of lines rolled);
- ``bound_512x1``: a launch bound of one 512-lane block an SM at every
  length, 128 registers a lane; ``bound_512x1_c8`` the same with 8
  columns a unit;
- ``unrolled``: the rounds of lines unrolled (``#pragma unroll``);
- ``bound_256_c8``: a launch bound of 256 threads a block, which lets a
  lane keep up to 255 registers, with 8 columns a unit.

Launches of more lanes than a variant's bound fail and are reported as
such. ``tools/strided_cols.py`` builds its variants with :func:`build`.

Every line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpufft_torch import _build, execute  # noqa: E402
from tpufft_torch.kernels import inner_fft, minor_fft  # noqa: E402

CSRC = "tpufft_torch/csrc"
SOURCES = ("strided_fft.cu", "strided_line_pow2.cu", "strided_line_r3.cu",
           "strided_line_r5.cu", "strided_line_r15.cu", "strided_line_odd.cu")
BOUND = ("__global__ void __launch_bounds__(\n"
         "    lane_threads(N1 * N2, std::is_same<T, __nv_bfloat16>::value),\n"
         "    lane_blocks(N1 * N2, std::is_same<T, __nv_bfloat16>::value))\n")
ROUNDS = ("#pragma unroll 1\n    for (int s = 0; s < R1; ++s) {",
          "#pragma unroll 1\n      for (int s = 0; s < R2; ++s) {")
# line_geometry's choice of C and its test of the form's lengths
WIDEST = ("  int cols = 32;\n"
          "  while (cols > min_cols &&\n"
          "         (cols > post || (g->n2 > 1 && cols * n / 32 > "
          "lane_threads(n, bf16))))\n"
          "    cols /= 2;\n")
SPLIT = "  if (!line_split(n, &g->n1, &g->n2)) return false;\n"
R3_STUB = """#include "strided_line.cuh"
namespace tpufft_strided {
template <typename T, bool kFused>
int launch_line_r3(const LineArgs&, const LineGeometry&) {
  return (int)cudaErrorInvalidValue;
}
template int launch_line_r3<float, false>(const LineArgs&,
                                           const LineGeometry&);
template int launch_line_r3<float, true>(const LineArgs&,
                                          const LineGeometry&);
template int launch_line_r3<__nv_bfloat16, false>(const LineArgs&,
                                                   const LineGeometry&);
template int launch_line_r3<__nv_bfloat16, true>(const LineArgs&,
                                                  const LineGeometry&);
}
"""
# (label, (pre, n, post), with the two-pass twiddle)
SHAPES = (("K2", (100, 640, 480), False),
          ("K2", (100, 640, 241), False),
          ("K3", (10, 128, 16384), False),
          ("n=1024", (16, 1024, 1024), False),
          ("K3 + twiddle", (16, 1024, 1024), True),
          ("n=2048", (8, 2048, 1024), False))


def header() -> str:
    """strided_line.cuh as it is, its patch markers checked."""
    head = open(os.path.join(CSRC, "strided_line.cuh")).read()
    for mark in (BOUND, WIDEST, SPLIT) + ROUNDS:
        assert head.count(mark) == 1, f"marker not unique: {mark!r}"
    return head


def with_cols(head: str, cols: int) -> str:
    """The header whose launches take C = cols wherever the form's bounds
    allow it (and the stage form where they do not)."""
    return head.replace(WIDEST, f"  int cols = {cols};\n")


def stages_only(head: str) -> str:
    """The header whose launches all run the stage form."""
    return head.replace(SPLIT, "  return false;  // the stage form\n")


def variants() -> dict:
    head = header()
    unrolled = head
    for mark in ROUNDS:
        unrolled = unrolled.replace(mark, mark.replace("unroll 1", "unroll"))
    bound = "__global__ void __launch_bounds__({})\n"
    bound_512 = head.replace(BOUND, bound.format("512, 1"))
    return {"full": head,
            "bound_512x1": bound_512,
            "bound_512x1_c8": with_cols(bound_512, 8),
            "unrolled": unrolled,
            "bound_256_c8": with_cols(
                head.replace(BOUND, bound.format("256, 1")), 8)}


def build(heads: dict, out: str, stub_r3: bool = True) -> dict:
    """Compile the strided sources with each patched header of ``heads``
    into ``out/<name>/libstrided.so`` (every nvcc started at once; the
    radix-3 launcher a stub when ``stub_r3``); returns {name: (the library
    bound through ctypes, nvcc's output)}."""
    nvcc = _build._nvcc()
    jobs = {}
    for name, head in heads.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        with open(os.path.join(d, "strided_line.cuh"), "w") as f:
            f.write(head)
        if stub_r3:
            with open(os.path.join(d, "strided_line_r3.cu"), "w") as f:
                f.write(R3_STUB)
        for src in SOURCES:
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(d, src),
                   "-o", os.path.join(d, src + ".o")]
            jobs[(name, src)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {name: "" for name in heads}
    for (name, src), proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {src}:\n"
                               f"{text[-3000:]}")
        logs[name] += text
    libs = {}
    for name in heads:
        d = os.path.join(out, name)
        path = os.path.abspath(os.path.join(d, "libstrided.so"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", path,
                        *(os.path.join(d, s + ".o") for s in SOURCES)],
                       check=True, capture_output=True)
        libs[name] = (bind(ctypes.CDLL(path)), logs[name])
    return libs


def bind(lib):
    """Declare the two entry points the tools call."""
    i32, i64, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.tpufft_strided_fft.argtypes = [vp] * 5 + [
        i64, i32, i64, ctypes.POINTER(i32), i32, vp, i32, i64, i32,
        ctypes.c_float, i32, vp]
    lib.tpufft_strided_fft_fused.argtypes = [vp] * 3 + [
        i64, i32, i64, i64, ctypes.POINTER(i32), i32, i32, ctypes.c_float,
        i32, vp]
    lib.tpufft_strided_line_geometry.argtypes = [i32, i64, i32,
                                                 ctypes.POINTER(i32)]
    return lib


def columns(lib, n: int, post: int) -> int | None:
    """C of the line form that ``lib``'s launch takes for f32 planes at n
    and post, or None for the stage form."""
    out = (ctypes.c_int * 5)()
    return out[2] if lib.tpufft_strided_line_geometry(n, post, 0, out) \
        else None


def report(text: str) -> str:
    """ptxas's registers and spill stores of each f32 split-plane
    strided_lane_kernel without the twiddle, by its (N1, N2)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(
                r"strided_lane_kernelIfLi(\d+)ELi(\d+)ELb0ELb0E", line)
            name = m and (int(m.group(1)), int(m.group(2)))
        elif name and "spill stores" in line:
            spills = line.split(", ")[1]
        elif name and "registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append(f"{name} {regs} registers, {spills}")
            name = None
    return "; ".join(out)


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    libs = build(variants(), "build/strided_phases")
    for name, (_, log) in libs.items():
        print(f"{name}: ptxas, f32 split-plane lane kernels: "
              f"{report(log)}", flush=True)
    i32 = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for label, (pre, n, post), with_tw in SHAPES:
        xr, xi = chip_smoke._device_planes((pre, n, post), 1)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        table = minor_fft._device_twiddles(n, False, xr.device)
        rad = minor_fft.radices(n)
        arr = (i32 * len(rad))(*rad)
        tw = (execute._device_two_pass_twiddle(n, post, False, xr.device)
              if with_tw else None)
        nbytes = 16 * xr.numel()
        geo = inner_fft.line_geometry(n, post, torch.float32)
        print(f"{card}: {label} {(pre, n, post)} f32, "
              f"{inner_fft.form(n, post, torch.float32)} form {geo}, "
              f"{nbytes / 1e6:.1f} MB moved", flush=True)
        for name, (lib, _) in libs.items():
            cols = columns(lib, n, post)

            def k():
                return lib.tpufft_strided_fft(
                    xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                    yi.data_ptr(), table.data_ptr(), pre, n, post, arr,
                    len(rad), None if tw is None else tw.data_ptr(),
                    0 if tw is None else post, 1, 0, 1.0, 0, stream)

            form = f"C={cols}" if cols else "stage form"
            if k() != 0:
                print(f"{card}: {name} {form}: not launched", flush=True)
                continue
            ms = chip_smoke._time_ms(k)
            print(f"{card}: {name} {form}: {ms:.4f} ms "
                  f"({nbytes / 1e9 / (ms * 1e-3):.0f} GB/s)", flush=True)
        del xr, xi, yr, yi


if __name__ == "__main__":
    main()
