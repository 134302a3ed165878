"""Where the time of the cluster kernels K5 and K6 goes, on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/cluster_phases.py

It compiles patched copies of ``tpufft_torch/csrc/cluster_fft.cu`` (and
of ``line_fft.cuh`` where a copy patches it) into
``build/cluster_phases/NAME/`` (``tools/variant_build.py``: one ``nvcc`` a
source, in parallel), each with some phases switched off, and times
``tpufft_cube_fft`` at (100, 64, 64, 64) and ``tpufft_mid_pair_fft`` at
(32, 64, 128, 128) in each (CUDA events, median of 20; the results of the
patched copies are wrong by design).

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

Every library links csrc's ``cluster_fft.cu`` and
``mid_line_{pow2,r3,r5,r7,r15}.cu``, compiled once into
``build/cluster_phases/common/``, unless the copy holds its own. K6's
generic-radix form (``mid_mixed_kernel`` in ``csrc/mid_line.cuh``) is
timed at (25, 160, 160, 48) and at T2's (25, 48,
160, 160) in every library; its own copies patch ``mid_line.cuh``:

- ``k6m_load``: returns after the tables, the load into the tile and the
  block barrier after it;
- ``k6m_load_n2``: returns after the n2 lines;
- ``k6m_local_exchange``: the n1 lines read the block's own tile instead
  of the cluster's (what distributed shared memory costs);
- ``k6m_no_store``: the n1 lines store nothing;
- ``k6m_no_fft``: neither step runs its lines' DFTs (the loads, the tile's
  and the cluster's reads and writes and the stores stay);
- ``k6m_bounds_1``, ``k6m_bounds_3``: launch bounds of 1 or 3 blocks of
  320 threads an SM instead of 2 (at most 204 or 68 registers instead of
  102).

The n2 lines are ``k6m_load_n2`` - ``k6m_load``; the exchange, the n1
lines, the store and the end barrier the full kernel - ``k6m_load_n2``.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import variant_build  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import (cube_fft, inner_fft, mid_pair_fft,  # noqa
                                  minor_fft, pair_fft)

CSRC = "tpufft_torch/csrc"
SRC = f"{CSRC}/cluster_fft.cu"
LINE_SRC = f"{CSRC}/line_fft.cuh"
MID_SRC = f"{CSRC}/mid_line.cuh"
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
# the generic-radix form's phases (mid_mixed_kernel, mid_line.cuh)
MIX_LOAD_END = "  __syncthreads();\n  with_mix_length(n2, [&](auto n) {\n"
MIX_N2_END = "  cluster.sync();\n  with_family<kFamily>(n1, [&](auto n) {\n"
MIX_REMOTE = "cluster.map_shared_rank(tile, owner)"
MIX_STORE = "    if (valid && l < left) {\n      const int64_t base"
MIX_BOUNDS = "__launch_bounds__(kMixThreads, 2)"
MIX_FFT = "    mix_fft<N>(v, tk.l, table, inv);\n"
# the pairs the generic-radix form is timed at: (160, 160) at L = 48, and
# T2's (48, 160) at L = 160; n1's family source is patched with the header
MIX_SHAPES = ((25, 160, 160, 48), (25, 48, 160, 160))


def variants() -> dict:
    """name -> {file name: text} of the copy's csrc files that differ from
    csrc or are compiled in the copy (a patched cluster_fft.cu, with a
    patched line_fft.cuh; a patched mid_line.cuh with the family sources of
    n1 that include it). ``full`` patches nothing: its library is csrc's
    objects."""
    out = {}
    for name, text in _sources().items():
        if name == "full":
            out[name] = {}
        elif isinstance(text, tuple):
            out[name] = {"cluster_fft.cu": text[0], "line_fft.cuh": text[1]}
        else:
            out[name] = {"cluster_fft.cu": text}
    mid = open(MID_SRC).read()
    for mark in (MIX_LOAD_END, MIX_N2_END, MIX_REMOTE, MIX_STORE,
                 MIX_BOUNDS, MIX_FFT):
        assert mark in mid, f"marker not found in {MID_SRC}: {mark!r}"
    mixed = {
        "k6m_load": mid.replace(MIX_LOAD_END, MIX_LOAD_END.replace(
            "  with_mix_length", "  return;\n  with_mix_length", 1)),
        "k6m_load_n2": mid.replace(MIX_N2_END, MIX_N2_END.replace(
            "  cluster.sync();", "  __syncthreads();\n  return;", 1)),
        "k6m_local_exchange": mid.replace(MIX_REMOTE, "tile"),
        "k6m_no_store": mid.replace(MIX_STORE, MIX_STORE.replace(
            "valid && l < left", "false", 1)),
        "k6m_no_fft": mid.replace(MIX_FFT, ""),
        "k6m_bounds_1": mid.replace(MIX_BOUNDS, MIX_BOUNDS.replace(
            "2)", "1)")),
        "k6m_bounds_3": mid.replace(MIX_BOUNDS, MIX_BOUNDS.replace(
            "2)", "3)")),
    }
    families = sorted({_family(n1) for _, n1, _, _ in MIX_SHAPES})
    for name, text in mixed.items():
        # the unpatched cluster_fft.cu takes nothing of the form's kernel
        # from the header, so csrc's object serves
        out[name] = {"mid_line.cuh": text,
                     **{f"mid_line_{f}.cu":
                        open(f"{CSRC}/mid_line_{f}.cu").read()
                        for f in families}}
    return out


def _family(n: int) -> str:
    """The family source of n1 (mid_line_<family>.cu)."""
    while n % 2 == 0:
        n //= 2
    return "pow2" if n == 1 else f"r{n}"


def _sources() -> dict:
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
    """Each copy built through ``tools/variant_build.py`` into
    ``build/cluster_phases/<name>/``: its own sources compiled in its copy
    of csrc, csrc's cluster_fft.cu and family sources compiled once into
    ``common/`` and linked into every copy that does not hold its own;
    name -> the library's path, with ptxas's line-form report printed."""
    built = variant_build.build(
        OUT, None, texts, lambda f: False,
        shared=lambda f: f == "cluster_fft.cu" or (
            f.startswith("mid_line_") and f.endswith(".cu")))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {line_form_resources(log)}", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def line_form_resources(log: str) -> str:
    """Registers and spill bytes of each line-form instantiation in a
    ptxas report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'(\w*(?:cube_line|mid_pair_line|mid_mixed)_kernel"
                      r"\w*)'", line)
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
            if "mid_mixed" in cur:   # one kernel a family of n1, any dtype
                kind = "K6 mixed n1 family " + re.search(
                    r"ILi(\d+)E", cur).group(1)
            else:
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
    mixed = []   # the generic-radix form's operands at MIX_SHAPES
    for shape in MIX_SHAPES:
        pre_, n1_, n2_, L_ = shape
        assert mid_pair_fft.form(n1_, n2_, L_) == "mixed", shape
        ar_, ai_ = chip_smoke._device_planes(shape, 5)
        r1_, r2_ = minor_fft.radices(n1_), minor_fft.radices(n2_)
        mixed.append((shape, ar_, ai_, torch.empty_like(ar_),
                      torch.empty_like(ai_),
                      minor_fft._device_twiddles(n1_, False, xr.device),
                      minor_fft._device_twiddles(n2_, False, xr.device),
                      (i32 * len(r1_))(*r1_), len(r1_),
                      (i32 * len(r2_))(*r2_), len(r2_),
                      mid_pair_fft.cluster_size(n1_, n2_)))
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

        def k6m(m):
            shape, ar_, ai_, br_, bi_, t1, t2, a1, l1, a2, l2, c = m
            err = lib.tpufft_mid_pair_fft(
                ar_.data_ptr(), ai_.data_ptr(), br_.data_ptr(),
                bi_.data_ptr(), t1.data_ptr(), t2.data_ptr(), shape[0],
                shape[1], shape[2], shape[3], mid_pair_fft.LINE_LANES, c, a1,
                l1, a2, l2, 0, 1.0, 0, stream)
            assert err == 0, err

        mixed_ms = ", ".join(f"{m[0]} {t(lambda: k6m(m)):.4f}" for m in mixed)
        print(f"{card}: {name}: K6 generic-radix form {mixed_ms} ms",
              flush=True)
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
