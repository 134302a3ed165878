"""Where the time of the cluster kernels K5 and K6 goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/cluster_phases.py

It compiles patched copies of ``tpufft_torch/csrc/cluster_fft.cu`` into
``build/cluster_phases/`` (one ``nvcc`` each, in parallel), each with some
phases switched off, and times ``tpufft_cube_fft`` at (100, 64, 64, 64) and
``tpufft_mid_pair_fft`` at (32, 64, 128, 128) in each (CUDA events, median
of 20; the results of the patched copies are wrong by design). Then it
times K6 at other tile geometries (lanes of L a tile, cluster size) through
the package, and the two-pass routes the kernels replace. Every line names
the card and its power limit.
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
from tpufft_torch.kernels import (cube_fft, inner_fft, mid_pair_fft,  # noqa
                                  minor_fft, pair_fft)

SRC = "tpufft_torch/csrc/cluster_fft.cu"
OUT = "build/cluster_phases"
STAGES = "                                       bool inv) {\n  const int n = plan.n;\n"
PERMUTE = ("                                        Src src, Dst dst) {\n")
GATHER = "                                       Remote remote, Dst dst) {\n"
REMOTE = "cluster.map_shared_rank(buf, owner)"


def variants() -> dict:
    src = open(SRC).read()
    for mark in (STAGES, PERMUTE, GATHER, REMOTE):
        assert mark in src, f"marker not found in {SRC}: {mark!r}"
    no_stages = src.replace(STAGES, STAGES.replace(
        "{\n", "{\n  __syncthreads();\n  return;\n", 1))
    skip = (PERMUTE, PERMUTE + "  return;\n"), (
        GATHER, GATHER + "  __syncthreads();\n  return;\n")
    out = {"full": src, "no_stages": no_stages}
    out["no_stages_local_gather"] = no_stages.replace(REMOTE, "buf").replace(
        "cluster.sync();", "__syncthreads();")
    s = no_stages
    for a, b in skip:
        s = s.replace(a, b)
    out["load_store_only"] = s
    s = src
    for a, b in skip:
        s = s.replace(a, b)
    out["stages_no_gather"] = s
    return out


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
    _build.load()
    t = chip_smoke._time_ms
    i32, vp = ctypes.c_int, ctypes.c_void_p
    arr = ctypes.POINTER(i32)
    xr, xi = chip_smoke._device_planes((100, 64, 64, 64), 1)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    mr, mi = chip_smoke._device_planes((32, 64, 128, 128), 2)
    zr, zi = torch.empty_like(mr), torch.empty_like(mi)
    tw64 = minor_fft._device_twiddles(64, False, xr.device)
    tw128 = minor_fft._device_twiddles(128, False, xr.device)
    r64, r128 = minor_fft.radices(64), minor_fft.radices(128)
    a64, a128 = (i32 * len(r64))(*r64), (i32 * len(r128))(*r128)
    stream = torch.cuda.current_stream().cuda_stream
    c5 = cube_fft.cluster_size(64, 64, 64)
    c6 = mid_pair_fft.cluster_size(64, 128)
    lanes = mid_pair_fft.LANES
    print(f"{card}: K5 (100, 64, 64, 64) clusters of {c5}; K6 "
          f"(32, 64, 128, 128) clusters of {c6} at {lanes} lanes")
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.tpufft_cube_fft.argtypes = [vp] * 7 + [
            ctypes.c_longlong, i32, i32, i32, i32, arr, i32, arr, i32, arr,
            i32, i32, ctypes.c_float, i32, vp]
        lib.tpufft_mid_pair_fft.argtypes = [vp] * 6 + [
            ctypes.c_longlong, i32, i32, ctypes.c_longlong, i32, i32, arr,
            i32, arr, i32, i32, ctypes.c_float, i32, vp]

        def k5():
            err = lib.tpufft_cube_fft(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                tw64.data_ptr(), tw64.data_ptr(), tw64.data_ptr(), 100, 64,
                64, 64, c5, a64, len(r64), a64, len(r64), a64, len(r64), 0,
                1.0, 0, stream)
            assert err == 0, err

        def k6():
            err = lib.tpufft_mid_pair_fft(
                mr.data_ptr(), mi.data_ptr(), zr.data_ptr(), zi.data_ptr(),
                tw64.data_ptr(), tw128.data_ptr(), 32, 64, 128, 128, lanes,
                c6, a64, len(r64), a128, len(r128), 0, 1.0, 0, stream)
            assert err == 0, err

        print(f"{card}: {name}: K5 {t(k5):.4f} ms, K6 {t(k6):.4f} ms",
              flush=True)
    v3 = (6400, 64, 64)

    def old_cube():
        ar, ai = inner_fft.fft_inner_nd(xr.reshape(v3), xi.reshape(v3), n=64,
                                        inverse=False, scale=1.0)
        return pair_fft.fft_pair(ar, ai, inverse=False, scale=1.0)

    print(f"{card}: routes replaced: K3 + K4 {t(old_cube):.4f} ms, K3 + K2 "
          f"{t(lambda: chip_smoke._axes_1_2(mr, mi)):.4f} ms")
    for shape in ((32, 64, 128, 128), (512, 64, 128, 8)):
        ar, ai = chip_smoke._device_planes(shape, 3)
        for lanes_, csize in ((8, 4), (8, 16), (4, 8), (4, 16), (2, 16)):
            mid_pair_fft.LANES = lanes_
            mid_pair_fft.cluster_size = lambda n1, n2, c=csize: c
            mid_pair_fft.active_clusters.cache_clear()
            ms = t(lambda: mid_pair_fft.fft_mid_pair(ar, ai, inverse=False,
                                                     scale=1.0))
            print(f"{card}: K6 {shape} at {lanes_} lanes, clusters of "
                  f"{csize}: {ms:.4f} ms")
        del ar, ai


if __name__ == "__main__":
    main()
