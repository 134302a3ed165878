"""Where the time of the cluster kernels K5 and K6 goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/cluster_phases.py

It compiles patched copies of ``tpufft_torch/csrc/cluster_fft.cu`` (and
of ``line_fft.cuh`` where a copy patches it) into
``build/cluster_phases/NAME/`` (one ``nvcc`` each, in parallel), each with some
phases switched off, and times ``tpufft_cube_fft`` at (100, 64, 64, 64) and
``tpufft_mid_pair_fft`` at (32, 64, 128, 128) in each (CUDA events, median
of 20; the results of the patched copies are wrong by design).

K5 at 64^3 runs the line form (``cube_line_kernel``); its copies are:

- ``k5_n3``: returns after the n3 pass (the load, the n3 FFTs, the tile
  writes and the block barrier after them);
- ``k5_n3_n2``: returns after the n2 pass;
- ``k5_local_exchange``: the n1 pass reads the block's own tile instead of
  the cluster's (what distributed shared memory costs);
- ``k5_joint_barrier``: the end barrier's arrive moves from after the last
  remote read to just before its wait (what the split saves);
- ``k5_256_threads``, ``k5_1024_threads``, ``k5_32_values``: whole kernels
  at other block geometries (256 or 1024 threads of 16 values, or 512 of
  32; these copies compute the right result).

``python3 tools/cluster_phases.py NAME ...`` builds and times only the
named copies beside ``full``. For each copy it prints the line-form
kernel's registers and spills (ptxas).

The n2 pass is ``k5_n3_n2`` - ``k5_n3``; the exchange, the n1 pass, the
store and the end barrier together are the full kernel - ``k5_n3_n2``.

K6 at (64, 128) runs its line form (``mid_pair_line_kernel``, the same
exchange and end barrier, so ``k5_local_exchange`` and
``k5_joint_barrier`` patch it too); its own copies are:

- ``k6_load``: returns after the load into the tile and the block
  barrier after it;
- ``k6_load_n2``: returns after the n2 lines;
- ``k6_scalar_loads``: the load one element a thread and plane (4 bytes)
  where it takes 16-byte loads;
- ``k6_bounds_2``, ``k6_bounds_3``: launch bounds of 2 or 3 blocks of
  256 threads an SM (128 or 80 registers) instead of 4 (64).

The n2 lines are ``k6_load_n2`` - ``k6_load``; the exchange, the n1 lines,
the store and the end barrier are the full kernel - ``k6_load_n2``. Each
library also times K6's stage form (``mid_pair_fft_kernel``, 4 lanes of L
a tile, clusters of 16), whose copies switch off the stages
(``no_stages``), read the gather from the block itself
(``no_stages_local_gather``), leave only the load and the store
(``load_store_only``), or skip the permutation and the gather
(``stages_no_gather``). Then it times K6 at other tile geometries (lanes
of L a tile: 8 runs the line form, 4 and 2 the stage form; cluster size)
through the package, and the two-pass routes the kernels replace. Every
line names the card and its power limit.
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
from tpufft_torch.kernels import (cube_fft, inner_fft, mid_pair_fft,  # noqa
                                  minor_fft, pair_fft)

SRC = "tpufft_torch/csrc/cluster_fft.cu"
LINE_SRC = "tpufft_torch/csrc/line_fft.cuh"
OUT = "build/cluster_phases"
STAGES = "                                       bool inv) {\n  const int n = plan.n;\n"
PERMUTE = ("                                        Src src, Dst dst) {\n")
GATHER = "                                       Remote remote, Dst dst) {\n"
REMOTE = "cluster.map_shared_rank(buf, owner)"
# the line form's phases (cube_line_kernel)
LINE = "// The line form of the cube kernel"
N3_END = "  __syncthreads();\n  with_length(n2, [&](auto n) {\n"
N2_END = "  cluster.sync();\n  with_length(n1, [&](auto n) {\n"
LINE_REMOTE = "cluster.map_shared_rank(tile, k1 >> slab_shift)"
ARRIVE = ("    if (it == rounds - 1) cluster_arrive();  "
          "// the last remote read is done\n")
WAIT = "  }\n  cluster_wait();\n}\n"
THREADS = "constexpr int kLineThreads = 512;"
# the mid-pair line form's phases (mid_pair_line_kernel)
MID_LOAD_END = "  __syncthreads();\n  with_length128(n2, [&](auto n) {\n"
MID_N2_END = "  cluster.sync();\n  with_length128(n1, [&](auto n) {\n"
MID_VECTOR = "  const int quads = L % 4 == 0 &&"
MID_BOUNDS = "__launch_bounds__(kMidThreads, 4)"
VALUES = "constexpr int kLineValues = 16;"


def variants() -> dict:
    """name -> the patched cluster_fft.cu, or (it, the patched
    line_fft.cuh)."""
    src = open(SRC).read()
    line_src = open(LINE_SRC).read()
    for mark in (STAGES, PERMUTE, GATHER, REMOTE, LINE, N3_END, N2_END,
                 LINE_REMOTE, ARRIVE, WAIT, THREADS, MID_LOAD_END,
                 MID_N2_END, MID_VECTOR, MID_BOUNDS):
        assert mark in src, f"marker not found in {SRC}: {mark!r}"
    assert VALUES in line_src, f"marker not found in {LINE_SRC}: {VALUES!r}"
    no_stages = src.replace(STAGES, STAGES.replace(
        "{\n", "{\n  __syncthreads();\n  return;\n", 1))
    skip = (PERMUTE, PERMUTE + "  return;\n"), (
        GATHER, GATHER + "  __syncthreads();\n  return;\n")
    out = {"full": src, "no_stages": no_stages}
    # the gather reads the block's own tile, and its two cluster barriers
    # (in gather(), before LINE) become block barriers; the line form keeps
    # its own
    head, tail = no_stages.split(LINE, 1)
    out["no_stages_local_gather"] = (
        head.replace("cluster.sync();", "__syncthreads();") + LINE + tail
    ).replace(REMOTE, "buf")
    s = no_stages
    for a, b in skip:
        s = s.replace(a, b)
    out["load_store_only"] = s
    s = src
    for a, b in skip:
        s = s.replace(a, b)
    out["stages_no_gather"] = s
    out["k5_n3"] = src.replace(N3_END, N3_END.replace(
        "  with_length", "  return;\n  with_length", 1))
    out["k5_n3_n2"] = src.replace(N2_END, N2_END.replace(
        "  cluster.sync();", "  __syncthreads();\n  return;", 1))
    out["k5_local_exchange"] = src.replace(LINE_REMOTE, "tile")
    out["k5_joint_barrier"] = src.replace(ARRIVE, "").replace(
        WAIT, WAIT.replace("  cluster_wait();", "  cluster_arrive();\n"
                           "  cluster_wait();"))
    for threads in (256, 1024):
        out[f"k5_{threads}_threads"] = src.replace(
            THREADS, THREADS.replace("512", str(threads)))
    out["k5_32_values"] = (src, line_src.replace(
        VALUES, VALUES.replace("16", "32")))
    out["k6_load"] = src.replace(MID_LOAD_END, MID_LOAD_END.replace(
        "  with_length128", "  return;\n  with_length128", 1))
    out["k6_load_n2"] = src.replace(MID_N2_END, MID_N2_END.replace(
        "  cluster.sync();", "  __syncthreads();\n  return;", 1))
    out["k6_scalar_loads"] = src.replace(
        MID_VECTOR, MID_VECTOR.replace("= L", "= false && L"))
    for blocks in (2, 3):
        out[f"k6_bounds_{blocks}"] = src.replace(
            MID_BOUNDS, MID_BOUNDS.replace("4", str(blocks)))
    return out


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        cu, header = (text, None) if isinstance(text, str) else text
        with open(os.path.join(d, "cluster_fft.cu"), "w") as f:
            f.write(cu)
        # a patched header beside the source is found before csrc's
        if header is not None:
            with open(os.path.join(d, "line_fft.cuh"), "w") as f:
                f.write(header)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared",
               "-Itpufft_torch/csrc", "-o", os.path.join(d, f"{name}.so"),
               os.path.join(d, "cluster_fft.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
        libs[name] = os.path.abspath(os.path.join(OUT, name, f"{name}.so"))
        print(f"{name}: ptxas {line_form_resources(text)}", flush=True)
    return libs


def line_form_resources(log: str) -> str:
    """Registers and spill bytes of each line-form instantiation in a
    ptxas report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'(\w*(?:cube_line|mid_pair_line)_kernel\w*)'", line)
        if m or "Compiling entry function" in line:
            cur = m.group(1) if m else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kind = ("K6 " if "mid_pair" in cur else "") + (
                "bf16" if "bfloat16" in cur else "f32") + (
                " fused" if "Lb1E" in cur else "")
            out.append(f"{kind} {m.group(1)} registers, {spill} bytes "
                       "spilled")
            cur = None
    return "; ".join(out)


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    texts = variants()
    if len(sys.argv) > 1:
        texts = {k: v for k, v in texts.items()
                 if k == "full" or k in sys.argv[1:]}
    libs = build(texts)
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
    st = torch.cat([xr, xi], -1)
    st_out = torch.empty_like(st)
    xb, xbi = xr.bfloat16(), xi.bfloat16()
    yb, ybi = torch.empty_like(xb), torch.empty_like(xbi)
    sr, si = chip_smoke._device_planes((800, 32, 32, 32), 4)
    s_out = torch.empty_like(sr), torch.empty_like(si)
    tw32, r32 = minor_fft._device_twiddles(32, False, xr.device), \
        minor_fft.radices(32)
    a32 = (i32 * len(r32))(*r32)
    c32 = cube_fft.cluster_size(32, 32, 32)
    stream = torch.cuda.current_stream().cuda_stream
    c5 = cube_fft.cluster_size(64, 64, 64)
    c6 = mid_pair_fft.cluster_size(64, 128)
    lanes = mid_pair_fft.lanes(64, 128)
    c6_stage = cube_fft.pick_cluster(64, 128 * mid_pair_fft.LANES)
    print(f"{card}: K5 (100, 64, 64, 64) clusters of {c5}; K6 "
          f"(32, 64, 128, 128) {mid_pair_fft.form(64, 128, 128)} form, "
          f"clusters of {c6} at {lanes} lanes; its stage form clusters of "
          f"{c6_stage} at {mid_pair_fft.LANES} lanes")
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.tpufft_cube_fft.argtypes = [vp] * 7 + [
            ctypes.c_longlong, i32, i32, i32, i32, arr, i32, arr, i32, arr,
            i32, i32, ctypes.c_float, i32, vp]
        lib.tpufft_cube_fft_fused.argtypes = [vp] * 5 + [
            ctypes.c_longlong, i32, i32, i32, i32, arr, i32, arr, i32, arr,
            i32, i32, ctypes.c_float, i32, vp]
        lib.tpufft_mid_pair_fft.argtypes = [vp] * 6 + [
            ctypes.c_longlong, i32, i32, ctypes.c_longlong, i32, i32, arr,
            i32, arr, i32, i32, ctypes.c_float, i32, vp]

        def k5(planes=(xr, xi, yr, yi), bf16=0):
            err = lib.tpufft_cube_fft(
                *(p.data_ptr() for p in planes),
                tw64.data_ptr(), tw64.data_ptr(), tw64.data_ptr(), 100, 64,
                64, 64, c5, a64, len(r64), a64, len(r64), a64, len(r64), 0,
                1.0, bf16, stream)
            assert err == 0, err

        def k16():
            err = lib.tpufft_cube_fft_fused(
                st.data_ptr(), st_out.data_ptr(), tw64.data_ptr(),
                tw64.data_ptr(), tw64.data_ptr(), 100, 64, 64, 64, c5, a64,
                len(r64), a64, len(r64), a64, len(r64), 0, 1.0, 0, stream)
            assert err == 0, err

        def k5_32():
            err = lib.tpufft_cube_fft(
                sr.data_ptr(), si.data_ptr(), s_out[0].data_ptr(),
                s_out[1].data_ptr(), tw32.data_ptr(), tw32.data_ptr(),
                tw32.data_ptr(), 800, 32, 32, 32, c32, a32, len(r32), a32,
                len(r32), a32, len(r32), 0, 1.0, 0, stream)
            assert err == 0, err

        def k6(lanes_=lanes, csize=c6):
            err = lib.tpufft_mid_pair_fft(
                mr.data_ptr(), mi.data_ptr(), zr.data_ptr(), zi.data_ptr(),
                tw64.data_ptr(), tw128.data_ptr(), 32, 64, 128, 128, lanes_,
                csize, a64, len(r64), a128, len(r128), 0, 1.0, 0, stream)
            assert err == 0, err

        k5_bf16 = t(lambda: k5((xb, xbi, yb, ybi), 1))
        print(f"{card}: {name}: K5 {t(k5):.4f} ms (bf16 {k5_bf16:.4f}, "
              f"(800, 32^3) {t(k5_32):.4f}), K16 {t(k16):.4f} ms, K6 "
              f"{t(k6):.4f} ms (stage form "
              f"{t(lambda: k6(mid_pair_fft.LANES, c6_stage)):.4f})",
              flush=True)
    v3 = (6400, 64, 64)

    def old_cube():
        ar, ai = inner_fft.fft_inner_nd(xr.reshape(v3), xi.reshape(v3), n=64,
                                        inverse=False, scale=1.0)
        return pair_fft.fft_pair(ar, ai, inverse=False, scale=1.0)

    print(f"{card}: routes replaced: K3 + K4 {t(old_cube):.4f} ms, K3 + K2 "
          f"{t(lambda: chip_smoke._axes_1_2(mr, mi)):.4f} ms")
    # K5 at (800, 32^3) over clusters of 2 to 16 blocks (16384 to 2048
    # elements a block), through the package
    pick = cube_fft.cluster_size
    for csize in (2, 4, 8, 16):
        cube_fft.cluster_size = lambda n1, n2, n3, c=csize: c
        cube_fft.active_clusters.cache_clear()
        ms = t(lambda: cube_fft.fft_cube(sr, si, inverse=False, scale=1.0))
        print(f"{card}: K5 (800, 32, 32, 32) clusters of {csize} "
              f"({cube_fft.active_clusters(32, 32, 32, False, 0)} at once): "
              f"{ms:.4f} ms")
    cube_fft.cluster_size = pick
    cube_fft.active_clusters.cache_clear()
    for shape in ((32, 64, 128, 128), (128, 64, 128, 32), (512, 64, 128, 8)):
        ar, ai = chip_smoke._device_planes(shape, 3)
        for lanes_, csize in ((8, 4), (8, 8), (8, 16), (4, 8), (4, 16),
                              (2, 16)):
            mid_pair_fft.lanes = lambda n1, n2, v=lanes_: v
            mid_pair_fft.cluster_size = lambda n1, n2, c=csize: c
            mid_pair_fft.active_clusters.cache_clear()
            ms = t(lambda: mid_pair_fft.fft_mid_pair(ar, ai, inverse=False,
                                                     scale=1.0))
            form = "line" if lanes_ == mid_pair_fft.LINE_LANES else "stage"
            print(f"{card}: K6 {shape} at {lanes_} lanes ({form} form), "
                  f"clusters of {csize}: {ms:.4f} ms")
        del ar, ai


if __name__ == "__main__":
    main()
