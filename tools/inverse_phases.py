"""Where the time of K8's and K14's line forms (the inverse-real line core
of ``tpufft_torch/csrc/real_fft.cuh``) goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/inverse_phases.py

It compiles patched copies of ``real_fft.cuh`` with ``real_fft.cu`` (K8)
and with ``stft_mm.cu`` (K14) into ``build/inverse_phases/`` (one ``nvcc``
each, all started together), each copy with one part switched off, and
times ``tpufft_irfft`` at (400000, 129) -> 256, (200000, 257) -> 512,
(100000, 513) -> 1024, (50000, 1025) -> 2048, (25000, 2049) -> 4096 and
(12500, 4097) -> 8192 f32 planes and ``tpufft_istft_frames`` at the
``istft`` path's shape, (64, 8193, 129) planes at nfft 256, hop 128 (CUDA
events, median of 20, one launch an event pair and, beside it, ten
back-to-back launches an event pair, which hide the host's time per
launch; the results of the copies that skip work are wrong by design):

- ``full``: the kernels as they are;
- ``tangle_by_4``: the tangle's loop unrolled by 4, not whole (the
  kernels unroll it whole for teams of one or two warps);
- ``no_fft``: the butterflies of both passes skipped (the tile passes,
  the twiddle products and the barriers stay);
- ``no_passes``: pass 1 and pass 2's butterflies skipped: the tangle, one
  read of the tile in pass 2's order, and the epilogue;
- ``no_epilogue``: K8's stores and K14's staging of the windowed pairs
  made conditional on a value that never occurs (the arithmetic stays);
  K14's overlap-add then reads stale tiles;
- ``no_ola``: K14's overlap-add loops skipped (nothing stored);
- ``tangle_only``: ``no_passes`` and ``no_epilogue`` together: the
  tangle's plane reads and tile writes;
- ``other_bound``: the other launch bound: K8 at K7's five 128-thread
  blocks an SM at every geometry (the kernel takes four, up to 128
  registers, where N1 = 32), K14 at four, not five.

Then ``torch.fft.irfft`` and ``torch.istft`` of the same data and a device
copy of each kernel's bytes. Every line names the card and its power
limit.
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
from tpufft_torch import _build, spectral  # noqa: E402
from tpufft_torch.kernels import minor_fft, real_fft, stft_mm  # noqa: E402

CSRC = "tpufft_torch/csrc"
OUT = "build/inverse_phases"
K8_SHAPES = ((400_000, 256), (200_000, 512), (100_000, 1024), (50_000, 2048),
             (25_000, 4096), (12_500, 8192))
K14_SHAPE = (64, 8193, 256, 128)   # batch, nseg, nfft = nperseg, hop
FFT1 = ("        pair_dft<32, m / 64>(u[s], p, table, true);\n",
        "        lane_dft<N1, m / N1, 0, 1>(u[s], table, true);\n")
FFT2 = ("      pair_dft<32, m / 64>(v[s], p, table, true);\n",
        "      lane_dft<N2, m / N2, 0, 1>(v[s], table, true);\n")
PASS1 = re.compile(r"  \{  // pass 1: .*?\n  \}\n", re.S)
K8_STORE = "      if (row < batch)\n        store_pair(y,"
K14_STAGE = "      tile[r * m + (j ^ ((N1 * r) & 15))] ="
OLA = "const int span = (nw + taps - 1) * hop;"
K8_BOUND = ("__launch_bounds__(kThreads, kIrfftMinBlocks(N1, kThreads))\n"
            "irfft_lane_kernel(")
K14_BOUND = "tpufft_minor::kLaneMinBlocks(kThreads))\nistft_lane_kernel("
NEVER = "1.2345e-30f"
UNROLL = "  constexpr int kUnroll = S::lanes <= 64 ? kIters : 4;\n"


def _one(text: str, mark: str, new: str) -> str:
    assert text.count(mark) == 1, f"marker not unique: {mark!r}"
    return text.replace(mark, new)


def variants() -> dict:
    """{name: (real_fft.cuh, real_fft.cu, stft_mm.cu)} texts."""
    core = open(os.path.join(CSRC, "real_fft.cuh")).read()
    k8 = open(os.path.join(CSRC, "real_fft.cu")).read()
    k14 = open(os.path.join(CSRC, "stft_mm.cu")).read()
    no_fft = core
    for mark in FFT1 + FFT2:
        no_fft = _one(no_fft, mark, "        ;\n")
    assert len(PASS1.findall(core)) == 1
    no_passes = PASS1.sub("", core)
    for mark in FFT2:
        no_passes = _one(no_passes, mark, "        ;\n")
    k8_quiet = _one(k8, K8_STORE, K8_STORE.replace(
        "row < batch", f"row < batch && z.x == {NEVER}"))
    k14_quiet = _one(k14, K14_STAGE, f"      if (z.x == {NEVER})\n"
                     + K14_STAGE)
    no_ola = _one(k14, OLA, "const int span = 0;")
    other = (core, _one(k8, K8_BOUND, K8_BOUND.replace(
        "kIrfftMinBlocks(N1, kThreads)", "kLaneMinBlocks(kThreads)")),
        _one(k14, K14_BOUND, K14_BOUND.replace(
            "tpufft_minor::kLaneMinBlocks(kThreads)", "4")))
    return {"full": (core, k8, k14),
            "other_bound": other,
            "tangle_by_4": (_one(core, UNROLL, UNROLL.replace(
                "S::lanes <= 64 ? kIters : 4", "4")), k8, k14),
            "no_fft": (no_fft, k8, k14),
            "no_passes": (no_passes, k8, k14),
            "no_epilogue": (core, k8_quiet, k14_quiet),
            "no_ola": (core, k8, no_ola),
            "tangle_only": (no_passes, k8_quiet, k14_quiet)}


def build(texts: dict) -> dict:
    """Each variant's K8 and K14 libraries: {name: (k8.so, k14.so)}."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (core, k8, k14) in texts.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in (("real_fft.cuh", core), ("real_fft.cu", k8),
                            ("stft_mm.cu", k14)):
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        for src in ("real_fft", "stft_mm"):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{CSRC}", "-o",
                   os.path.join(d, f"{src}.so"), os.path.join(d, f"{src}.cu")]
            procs[name, src] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (name, src), proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {src}:\n"
                               f"{text[-3000:]}")
        libs.setdefault(name, {})[src] = os.path.abspath(
            os.path.join(OUT, name, f"{src}.so"))
        print(f"{name} {src}: ptxas, f32 line kernels: {report(text)}",
              flush=True)
    return libs


def report(text: str) -> str:
    """ptxas's registers and spill stores of each f32 line-form kernel of
    K8 (irfft_lane_kernel) and K14 (istft_lane_kernel)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(i(?:rfft|stft)_lane_kernelIf(?:Li\d+E)+)", line)
            name = m and m.group(1)
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
    for rows, n in K8_SHAPES:
        hr, hi = chip_smoke._device_planes((rows, n // 2 + 1), 1)
        y = torch.empty(rows, n, device="cuda")
        tw, half, rad, nstages = real_fft._launch_args(n, True, hr.device)
        nbytes = 4 * (2 * hr.numel() + y.numel())
        print(f"{card}: K8 ({rows}, {n // 2 + 1}) -> ({rows}, {n}) f32, "
              f"{real_fft.form(n)} form, {nbytes / 1e6:.1f} MB moved",
              flush=True)
        for name, paths in libs.items():
            lib = ctypes.CDLL(paths["real_fft"])
            lib.tpufft_irfft.argtypes = [vp] * 5 + [
                i64, i32, ctypes.POINTER(i32), i32, ctypes.c_float, i32, vp]

            def k8():
                err = lib.tpufft_irfft(
                    hr.data_ptr(), hi.data_ptr(), y.data_ptr(),
                    tw.data_ptr(), half.data_ptr(), rows, n, rad, nstages,
                    1.0 / n, 0, stream)
                assert err == 0, err

            one, many = t(k8), chip_smoke._back_to_back_ms(k8)
            print(f"  {name}: {one:.4f} ms ({nbytes / 1e9 / (one * 1e-3):.0f}"
                  f" GB/s), back to back {many:.4f} ms", flush=True)
        hc = torch.complex(hr, hi)
        print(f"  torch.fft.irfft {t(lambda: torch.fft.irfft(hc, n=n)):.4f} "
              f"ms, copy floor {chip_smoke._copy_floor_ms(nbytes):.4f} ms",
              flush=True)
        del hr, hi, hc, y
    batch, nseg, nfft, hop = K14_SHAPE
    m1 = nfft // 2 + 1
    zr, zi = chip_smoke._device_planes((batch, nseg, m1), 2)
    win = torch.hann_window(nfft, device="cuda", dtype=torch.float64)
    syn = spectral._frame_tables(win.cpu().numpy(), nfft,
                                 float(win.sum().item()), zr.device)
    tw = minor_fft._device_twiddles(nfft // 2, True, zr.device)
    half = real_fft._device_half_twiddle(nfft, zr.device)
    out = torch.empty(batch, (nseg - 1) * hop + nfft, device="cuda")
    nbytes = 4 * (2 * zr.numel() + out.numel())
    print(f"{card}: K14 ({batch}, {nseg}, {m1}) -> {tuple(out.shape)} f32, "
          f"hop {hop}, {stft_mm.istft_form(nfft)} form, {nbytes / 1e6:.1f} "
          "MB moved", flush=True)
    for name, paths in libs.items():
        lib = ctypes.CDLL(paths["stft_mm"])
        lib.tpufft_istft_frames.argtypes = [vp] * 10 + [i64] + [i32] * 5 + [
            vp]

        def k14():
            err = lib.tpufft_istft_frames(
                zr.data_ptr(), zi.data_ptr(), *(a.data_ptr() for a in syn),
                tw.data_ptr(), half.data_ptr(), None, None, out.data_ptr(),
                batch, nseg, hop, nfft, nfft, 0, stream)
            assert err == 0, err

        one, many = t(k14), chip_smoke._back_to_back_ms(k14)
        print(f"  {name}: {one:.4f} ms ({nbytes / 1e9 / (one * 1e-3):.0f} "
              f"GB/s), back to back {many:.4f} ms", flush=True)
    zc = torch.complex(zr, zi).transpose(1, 2)
    w32 = win.float()
    lib_ms = t(lambda: torch.istft(zc, nfft, hop, window=w32, center=True))
    print(f"  torch.istft {lib_ms:.4f} ms, copy floor "
          f"{chip_smoke._copy_floor_ms(nbytes):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
