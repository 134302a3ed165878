"""Where the time of the pair kernel (K4, and K17 on fused storage) goes,
and how the forms that overlap its loads with its stages compare, on the
card.

Run from the repository root on a machine with the GPU:

    python3 tools/pair_phases.py

It compiles copies of ``tpufft_torch/csrc/pair_fft.cu`` into
``build/pair_phases/`` (one ``nvcc`` each, in parallel), patched as below,
and times each through the port's wrappers (``pair_fft.fft_pair``,
``fft_pair_padded``, ``fused_fft.fft_pair_fused``; CUDA events, median of
20):

- ``full``: the kernel as it is (a block a run of slices; plans of
  radices 2, 4 and 8 on an instantiation without the odd stages);
- ``odd_compiled``: every plan on the instantiation that compiles the odd
  stages too;
- ``persistent``: a persistent grid, as many blocks as the device holds
  at once, each looping over runs b, b + gridDim.x, ...;
- ``persistent_l2_prefetch``: the persistent grid, each block asking L2
  for its next run (``prefetch.global.L2``, a 128-byte line a thread)
  between its row and column passes, so that the next load overlaps the
  column pass;
- ``two_blocks`` and ``four_blocks``: at n1 n2 = 16384 (one 139 KB slice
  and one 1024-thread block an SM in the kernel) a slice is split over a
  cluster of 2 (4) blocks of 512 (256) threads, each holding n1/2 (n1/4)
  rows in a 70 (35) KB tile, so that 2 (4) blocks share an SM; after the
  row pass each block gathers n2/2 (n2/4) columns of every block's rows
  through distributed shared memory, between two ``cluster.sync()``s, and
  runs the column pass on them;
- ``rows_then_store``: the column pass cut to its last stage (the one that
  stores), so the time is the load, the row stages and the store;
- ``load_and_store``: both passes cut to one stage, the row pass's first
  (the one that loads) and the column pass's last: the kernel's memory
  traffic with one butterfly a pass.

The shapes: (1280, 128, 128) c64 split planes, the same in bf16 and as
the (1280, 128, 2 x 128) fused array (K17); ``fft2(s=(64, 128))``'s
(10000, 64, 93) zero-padded to 128; the packed form on (200000, 8, 93).
Every variant but the cut ones is checked against ``torch.fft.fft2``
(normalized max error). Each variant's ptxas report gives the registers
and spills of its f32 kernels and, from those and the tile, the blocks an
SM holds. The last lines time ``torch.fft.fft2`` and a device copy of
each shape's bytes. Every line names the card and its power limit.
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
from tpufft_torch.kernels import fused_fft, pair_fft  # noqa: E402

SRC = "tpufft_torch/csrc/pair_fft.cu"
OUT = "build/pair_phases"

# markers in SRC (each must occur once)
INCLUDE = '#include "team_stages.cuh"\n'
KERNEL = "// Block b transforms slices [b*slabs, b*slabs + slabs) of the planes"
FIRST = "  const int64_t s0 = (int64_t)blockIdx.x * slabs;\n"
BETWEEN = ("  __syncthreads();\n"
           "  {  // the n1 transforms of the slabs * n2 columns")
COLS = "          buf, tw1, plan1, ln, inv, true, tm,\n"
LAST = ("          [](int, int) { return make_float2(0.f, 0.f); }, store);\n"
        "    }\n  }\n}\n")
ROWS = "      team_pass<kPer, kOdd>(buf, tw2, plan2, ln, inv, from_tile, tm,\n"
GRID = ("  const long long blocks = (pre + g.rows - 1) / g.rows;\n"
        "  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;\n")
ODD = "  if (has_odd(plan1) || has_odd(plan2))\n"
PLANS = "template <typename T, bool kPadded, bool kFused>\nint launch_plans("

# the persistent grid: a block loops over runs b, b + gridDim.x, ...; the
# grid is as many blocks as the device holds at once
PERSIST_LOOP = ("  const int64_t runs = (pre + slabs - 1) / slabs;\n"
                "  for (int64_t run = blockIdx.x; run < runs;"
                " run += gridDim.x) {\n"
                "  const int64_t s0 = run * slabs;\n")
PERSIST_END = "  __syncthreads();\n  }\n}\n"
PERSIST_GRID = r"""  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t qerr = cudaGetDevice(&dev);
  if (qerr == cudaSuccess)
    qerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (qerr == cudaSuccess)
    qerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         g.threads, g.smem);
  if (qerr != cudaSuccess) return (int)qerr;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long runs = (pre + g.rows - 1) / g.rows;
  const long long blocks = runs < (long long)sms * per_sm
                               ? runs : (long long)sms * per_sm;
"""
# the L2 requests of a block's next run, between its passes
PREFETCH = r"""
  if (run + gridDim.x < runs) {
    const int64_t in_area = kFused ? 2 * area
                            : kPadded ? (int64_t)n1 * n2_in : area;
    const int64_t s1 = s0 + (int64_t)gridDim.x * slabs;
    const int64_t n = pre - s1 < slabs ? pre - s1 : slabs;
    const int64_t bytes = n * in_area * (int64_t)sizeof(T);
    prefetch_l2(xr + s1 * in_area, bytes);
    if (!kFused) prefetch_l2(xi + s1 * in_area, bytes);
  }
"""
PREFETCH_L2 = r"""// Ask L2 for the `bytes` bytes at p, a 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes) {
  const uintptr_t end = (uintptr_t)p + (uintptr_t)bytes;
  for (uintptr_t a = ((uintptr_t)p & ~(uintptr_t)127) + threadIdx.x * 128u;
       a < end; a += blockDim.x * 128u)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

"""
# the cluster form: at n1 n2 = 16384 a slice is split over a cluster of
# kC blocks of 1024 / kC threads, each holding n1 / kC rows in its tile;
# after the row pass each block gathers n2 / kC columns of every block's
# rows (distributed shared memory, between two cluster.sync()s) and runs
# the column pass on them
CLUSTER = r"""
constexpr int kC = KC;  // blocks a slice
constexpr int kThreadsC = 1024 / KC;

""" + r"""// The cluster form: cluster c (blocks kC c .. kC c + kC - 1) transforms
// slice c; n1 and n2 are powers of two (n1 n2 = 16384), at least kC.
template <typename T, bool kPadded, bool kFused>
__global__ void __launch_bounds__(kThreadsC, kC)
pair_fft_cluster(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ yr, T* __restrict__ yi,
                 const float2* __restrict__ tw1,
                 const float2* __restrict__ tw2, Radices plan1,
                 Radices plan2, int n2_in, int inverse, float scale,
                 int row_warps, int col_warps) {
  constexpr int kPer = 16;
  extern __shared__ float2 tpufft_pair_smem[];
  float2* buf = tpufft_pair_smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const int n1 = plan1.n, n2 = plan2.n, area = n1 * n2;
  const int h1 = n1 / kC, h2 = n2 / kC, part = area / kC;
  const int64_t slice = blockIdx.x / kC;
  const int64_t base = slice * area;
  const bool inv = inverse != 0;
  {  // rows h h1 .. h h1 + h1 - 1, as tile[r n2 + i]
    const Team tm(row_warps);
    int l0, cnt;
    share(tm, h1, l0, cnt);
    if (cnt > 0) {
      const Lines<false> ln(l0, cnt, n2, n2, part);
      const auto load = [&](int r, int i) {
        int64_t g;
        if (kPadded) {
          if (i >= n2_in) return make_float2(0.f, 0.f);
          g = (slice * n1 + h * h1 + r) * n2_in + i;
        } else {
          g = base + (int64_t)(h * h1 + r) * n2 + i;
          if (kFused) g = fused_index(g, i);
        }
        return make_float2(load_f(xr, g), load_f(xi, g));
      };
      team_pass<kPer, false>(buf, tw2, plan2, ln, inv, false, tm, load,
                             [](int, int, float2) {});
    }
  }
  cluster.sync();
  {  // gather columns h h2 .. h h2 + h2 - 1 of every block's rows as
     // tile[k1 h2 + c]
    const Div by_h2(h2), by_h1(h1);
    float2 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreadsC;
      if (e < part) {
        const int k1 = by_h2(e), c = e - k1 * h2;
        const int owner = by_h1(k1), r = k1 - owner * h1;
        v[j] = cluster.map_shared_rank(buf, owner)[pad(r * n2 + h * h2 + c)];
      }
    }
    cluster.sync();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreadsC;
      if (e < part) buf[pad(e)] = v[j];
    }
  }
  __syncthreads();
  {  // the n1 transforms of the h2 columns, stored from registers
    const Team tm(col_warps);
    int l0, cnt;
    share(tm, h2, l0, cnt);
    if (cnt > 0) {
      const Lines<true> ln(l0, cnt, n1, h2, part);
      const auto store = [&](int c, int k1, float2 w) {
        const int k2 = h * h2 + c;
        int64_t g = base + (int64_t)k1 * n2 + k2;
        if (kFused) g = fused_index(g, k2);
        store_f(yr, g, w.x * scale);
        store_f(yi, g, w.y * scale);
      };
      team_pass<kPer, false>(buf, tw1, plan1, ln, inv, true, tm,
                             [](int, int) { return make_float2(0.f, 0.f); },
                             store);
    }
  }
}

template <typename T, bool kPadded, bool kFused>
int launch_cluster(const void* xr, const void* xi, void* yr, void* yi,
                   const void* tw1, const void* tw2, long long pre,
                   const Radices& plan1, const Radices& plan2, int n2_in,
                   int inverse, float scale, cudaStream_t stream) {
  auto* kernel = pair_fft_cluster<T, kPadded, kFused>;
  const size_t smem = (size_t)pad(plan1.n * plan2.n / kC) * sizeof(float2);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (kC * pre > INT_MAX) return (int)cudaErrorInvalidValue;
  const int W = kThreadsC / 32;
  const int row_warps = team_warps(W, plan1.n / kC, plan2.n, 16, false);
  const int col_warps = team_warps(W, plan2.n / kC, plan1.n, 16, true);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(kC * pre));
  cfg.blockDim = dim3(kThreadsC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xr),
                           static_cast<const T*>(xi), static_cast<T*>(yr),
                           static_cast<T*>(yi),
                           static_cast<const float2*>(tw1),
                           static_cast<const float2*>(tw2), plan1, plan2,
                           n2_in, inverse, scale, row_warps, col_warps);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

"""
CLUSTER_CALL = r"""  if (plan1.n * plan2.n == kMaxN && plan1.n >= kC && plan2.n >= kC)
    return launch_cluster<T, kPadded, kFused>(xr, xi, yr, yi, tw1, tw2, pre,
                                              plan1, plan2, n2_in, inverse,
                                              scale, stream);
"""
# a one-stage plan of the pass's last (CUT_LAST) or first (CUT_FIRST) radix
CUT_LAST = ("      Radices cut = plan1;\n"
            "      cut.r[0] = plan1.r[plan1.count - 1];\n"
            "      cut.count = 1;\n")
CUT_FIRST = ("      Radices cut = plan2;\n"
             "      cut.count = 1;\n")
SHAPES = (("K4 (1280, 128, 128) f32", "pair", (1280, 128, 128), 128, False),
          ("K4 (1280, 128, 128) bf16", "pair", (1280, 128, 128), 128, True),
          ("K17 (1280, 128, 2 x 128) f32", "fused", (1280, 128, 128), 128,
           False),
          ("K4 n2_in (10000, 64, 93 -> 128) f32", "pair", (10000, 64, 93),
           128, False),
          ("K4 packed (200000, 8, 93) f32", "pair", (200000, 8, 93), 93,
           False))
CUT = ("rows_then_store", "load_and_store")


def variants() -> dict:
    src = open(SRC).read()
    for mark in (INCLUDE, KERNEL, FIRST, BETWEEN, COLS, LAST, ROWS, GRID, ODD,
                 PLANS):
        assert src.count(mark) == 1, f"marker not unique in {SRC}: {mark!r}"
    persistent = (src.replace(FIRST, PERSIST_LOOP)
                  .replace(LAST, LAST[:-2] + PERSIST_END)
                  .replace(GRID, PERSIST_GRID))
    cols_cut = "      team_pass<kPer, kOdd>(\n" + COLS.replace("plan1", "cut")
    rows_then_store = src.replace(COLS, COLS.replace("plan1", "cut")).replace(
        cols_cut, CUT_LAST + cols_cut)
    out = {"full": src,
           "odd_compiled": src.replace(ODD, "  if (true)\n"),
           "persistent": persistent,
           "persistent_l2_prefetch": persistent.replace(
               BETWEEN, PREFETCH + BETWEEN).replace(
                   KERNEL, PREFETCH_L2 + KERNEL),
           "rows_then_store": rows_then_store,
           "load_and_store": rows_then_store.replace(
               ROWS, CUT_FIRST + ROWS.replace("plan2", "cut"))}
    for kc, name in ((2, "two_blocks"), (4, "four_blocks")):
        out[name] = (src.replace(INCLUDE, "#include <cooperative_groups.h>\n"
                                 + INCLUDE + "namespace cg = "
                                 "cooperative_groups;\n")
                     .replace(PLANS, CLUSTER.replace("KC", str(kc)) + PLANS)
                     .replace(ODD, CLUSTER_CALL + ODD))
    return out


def build(texts: dict) -> dict:
    """name -> (library path, ptxas report)."""
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
        libs[name] = (os.path.abspath(os.path.join(OUT, f"{name}.so")), text)
    return libs


def resources(report: str, threads_c: int) -> list[tuple]:
    """(threads, values a thread, padded, fused, odd radices, registers,
    spill stores, tile elements) of each f32 pair kernel in a ptxas report;
    a cluster kernel has threads_c threads."""
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w*pair_fft_\w*)'", line)
        if m:
            cur = {"name": m.group(1)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cur["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs, spill = int(m.group(1)), cur.get("spill", 0)
            tm = re.search(r"kernelIfLi(\d+)ELi(\d+)ELi\d+ELb([01])ELb([01])"
                           r"ELb([01])", cur["name"])
            tc = re.search(r"clusterIfLb([01])ELb([01])", cur["name"])
            if tm:
                threads, per, padded, fused, odd = map(int, tm.groups())
                tile = 16384 if threads == 1024 else 4096
                out.append((threads, per, padded, fused, odd, regs, spill,
                            tile))
            elif tc:
                padded, fused = map(int, tc.groups())
                out.append((threads_c, 16, padded, fused, 0, regs, spill,
                            16 * threads_c))
            cur = None
    return out


def blocks_an_sm(threads: int, regs: int, tile: int) -> int:
    """Blocks an H100 SM holds: 65536 registers (8 a thread at a time),
    228 KB of shared memory (1 KB of it each block's own, the tile padded
    by 1/16), 2048 threads."""
    smem = 8 * (tile + tile // 16)
    by_regs = 65536 // (threads * ((regs + 7) // 8 * 8))
    return min(by_regs, (228 * 1024) // (smem + 1024), 2048 // threads)


class _Lib:
    """The two pair entry points of one variant's library, typed."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ri = ctypes.POINTER(i32)
        self.tpufft_pair_fft = lib.tpufft_pair_fft
        self.tpufft_pair_fft.argtypes = [vp] * 6 + [
            i64, i32, i32, i32, ri, i32, ri, i32, i32, ctypes.c_float, i32,
            vp]
        self.tpufft_pair_fft_fused = lib.tpufft_pair_fft_fused
        self.tpufft_pair_fft_fused.argtypes = [vp] * 4 + [
            i64, i32, i32, ri, i32, ri, i32, i32, ctypes.c_float, i32, vp]


def call(kind, xr, xi, n2, st):
    kw = dict(inverse=False, scale=1.0)
    if kind == "fused":
        return fused_fft.fft_pair_fused(st, **kw)
    if n2 != xr.shape[-1]:
        return pair_fft.fft_pair_padded(xr, xi, n2=n2, **kw)
    return pair_fft.fft_pair(xr, xi, **kw)


def error(kind, xr, xi, n2, out) -> float:
    x = torch.complex(xr[:8].float(), xi[:8].float())
    want = torch.fft.fft2(torch.nn.functional.pad(x, (0, n2 - x.shape[-1])))
    if kind == "fused":
        got = torch.complex(out[:8, ..., :n2].float(),
                            out[:8, ..., n2:].float())
    else:
        got = torch.complex(out[0][:8].float(), out[1][:8].float())
    return ((got - want).abs().max() / want.abs().max()).item()


def main() -> None:
    card = chip_smoke._smi("name,power.limit")
    libs = build(variants())
    for name, (_, report) in libs.items():
        threads_c = {"two_blocks": 512, "four_blocks": 256}.get(name, 0)
        for (threads, per, padded, fused, odd, regs, spill,
             tile) in resources(report, threads_c):
            print(f"{card}: {name}: {threads} threads, {per} values a "
                  f"thread, padded {padded}, fused {fused}, odd {odd}: "
                  f"{regs} registers, {spill} bytes spilled, "
                  f"{blocks_an_sm(threads, regs, tile)} blocks an SM "
                  f"(tile of {tile})")
    t = chip_smoke._time_ms
    data = {}
    for label, kind, shape, n2, bf16 in SHAPES:
        xr, xi = chip_smoke._device_planes(shape, 3)
        if bf16:
            xr, xi = xr.bfloat16(), xi.bfloat16()
        st = torch.cat([xr, xi], -1) if kind == "fused" else None
        data[label] = (kind, xr, xi, n2, st)
    for name, (path, _) in libs.items():
        lib = _Lib(path)
        _build.load = lambda lib=lib: lib
        for label, (kind, xr, xi, n2, st) in data.items():
            out = call(kind, xr, xi, n2, st)
            err = ("" if name in CUT else
                   f", error {error(kind, xr, xi, n2, out):.2e}")
            ms = t(lambda: call(kind, xr, xi, n2, st))
            print(f"{card}: {name}: {label}: {ms:.4f} ms{err}", flush=True)
    for label, (kind, xr, xi, n2, _) in data.items():
        x = torch.complex(xr.float(), xi.float())
        lib_ms = t(lambda: torch.fft.fft2(x, s=(x.shape[1], n2)))
        nbytes = xr.element_size() * 2 * (xr.numel()
                                          + xr.numel() // xr.shape[-1] * n2)
        print(f"{card}: {label}: torch.fft.fft2 {lib_ms:.4f} ms; copy of "
              f"{nbytes / 1e6:.1f} MB {chip_smoke._copy_floor_ms(nbytes):.4f} "
              f"ms", flush=True)
        del x


if __name__ == "__main__":
    main()
