"""K6's generic-radix cluster line form (``mid_mixed_kernel``,
``tpufft_torch/csrc/mid_line.cuh``) on the card: patched copies of the
header against the tree's, in turns, without the rest of the library.

Run from the repository root on a machine with the GPU:

    python3 tools/mid_mixed_ab.py [--turns N] [--shapes P,N1,N2,L ...]
                                  [VARIANT ...]

Each variant is a copy of ``mid_line.cuh`` with texts replaced (below;
``tree`` is the header as it is; the probes' results are wrong by design
and not checked). For each variant and each family of n1
the shapes need, the tool adds a small source to the variant's copy of
csrc that includes the header and exposes ``launch_mixed_as`` /
``mixed_clusters_as`` with a plain C interface, builds the copies through
``tools/variant_build.py`` (one nvcc a source, all started together, into
``build/mid_mixed_ab/<variant>/``) and binds each library with ctypes.
It prints ptxas's registers and spills of each variant's kernels, then
for each shape (pre, n1, n2, L) in c64:
each variant held against the plain version
(``mid_pair_fft.fft_mid_pair_reference``, f32 1e-5), and the variants
timed in turns by CUDA events (median of 20 after two warm-up calls;
``--turns`` rounds of tree, variant, variant, tree), beside the copy floor
of one read and one write. Every line names the card and its power limit;
the last line is a JSON object of the medians.

The default shapes are the form's timed ones (``chip_smoke.py`` phase 32)
and the same bytes at L = 8, where a tile's rows of 8 lanes are
contiguous in memory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import variant_build  # noqa: E402
from tpufft_torch.kernels import mid_pair_fft, minor_fft  # noqa: E402

CSRC = "tpufft_torch/csrc"
HEADER = f"{CSRC}/mid_line.cuh"
OUT = "build/mid_mixed_ab"
SHAPES = ((25, 160, 160, 48), (150, 160, 160, 8), (25, 48, 160, 160),
          (500, 48, 160, 8), (32, 56, 56, 256), (16, 256, 128, 32))

# the persistent grid: the kernel's tile loop, the launch's grid from the
# resident clusters (asked once a device and geometry)
PERSISTENT = [
    ("#include <climits>\n",
     "#include <array>\n#include <climits>\n#include <map>\n"
     "#include <mutex>\n"),
    ("                 const float2* __restrict__ tw2, int n1, int n2, "
     "int64_t L,\n                 int csize, int bf16,",
     "                 const float2* __restrict__ tw2, int n1, int n2, "
     "int64_t L,\n                 int64_t tiles, int csize, int bf16,"),
    ("""  const int64_t tile_id = blockIdx.x / csize;
  const int64_t ltiles = (L + kMidLanes - 1) / kMidLanes;
  const int64_t p = tile_id / ltiles;""",
     """  const int64_t ltiles = (L + kMidLanes - 1) / kMidLanes;
  for (int64_t tile_id = blockIdx.x / csize; tile_id < tiles;
       tile_id += gridDim.x / csize) {
  const int64_t p = tile_id / ltiles;"""),
    ("""                               slabs, n2, inv, scale);
  });
}
""", """                               slabs, n2, inv, scale);
  });
  }
}
"""),
    ("""template <int kFamily>
int launch_mixed_as(const MixArgs& a) {""", """template <int kFamily>
int mixed_clusters_as(int n1, int n2, int csize, int* out);

template <int kFamily>
int launch_mixed_as(const MixArgs& a) {"""),
    ("""  const long long blocks =
      a.pre * ((a.L + kMidLanes - 1) / kMidLanes) * a.csize;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
""", """  const long long tiles = a.pre * ((a.L + kMidLanes - 1) / kMidLanes);
  int device = 0, resident = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 1;
  {
    static std::mutex lock;
    static std::map<std::array<int, 4>, int> known;
    const std::array<int, 4> key = {device, a.n1, a.n2, a.csize};
    std::lock_guard<std::mutex> hold(lock);
    const auto it = known.find(key);
    if (it != known.end()) {
      resident = it->second;
    } else {
      const int e = mixed_clusters_as<kFamily>(a.n1, a.n2, a.csize,
                                               &resident);
      if (e != 0) return e;
      known[key] = resident;
    }
  }
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (tiles < resident ? tiles : resident) * a.csize;
"""),
    ("(int64_t)a.L, a.csize, a.bf16, a.quads,",
     "(int64_t)a.L, (int64_t)tiles, a.csize, a.bf16, a.quads,"),
]

# name -> [(text in the header, its replacement), ...]
VARIANTS = {
    "tree": [],
    # lines of up to 48 values a lane, every line's lanes exchanging
    # whole radix-G butterflies (G <= V), blocks of up to 192 threads
    "values48": [("constexpr int kMixThreads = 320;",
                  "constexpr int kMixThreads = 192;"),
                 ("constexpr int kMixValues = 32;",
                  "constexpr int kMixValues = 48;"),
                 ("while (R * v > kMixValues && v > 1) v /= 2;",
                  "while (R * v > kMixValues && (v / 2) * (v / 2) >= P) "
                  "v /= 2;")],
    # lines of up to 24 values a lane (56: 14 values on 4 lanes, 240: 15
    # on 16)
    "values24": [("constexpr int kMixValues = 32;",
                  "constexpr int kMixValues = 24;")],
    # the tile's groups of 4 XORed with ((k2 >> 1) ^ (k2 >> 3)) & 3: no
    # conflict in the n2 lines' writes at (160, 160) and (48, 160) in the
    # tile model (tests/test_torch_kernel_mid_pair.py)
    "swizzle_x3": [("((((k2 & 1) << 3) | l) ^ (((k2 >> 1) & 3) << 2));",
                    "((((k2 & 1) << 3) | l) ^ ((((k2 >> 1) ^ (k2 >> 3)) & 3)"
                    " << 2));")],
    # 16 row loads in flight a thread instead of 8
    "unroll16": [("constexpr int kMidLoadUnroll = 8;",
                  "constexpr int kMidLoadUnroll = 16;")],
    # the resident clusters looping over the tiles (each tile's load after
    # the last tile's end barrier, overlapping its stores) instead of a
    # cluster a tile
    "persistent": PERSISTENT,
    # probes (wrong results): the n1 lines' stores kept in the code but
    # skipped at run time; no DFT in the n1 or in the n2 lines; no cluster
    # barrier between the steps (a block barrier instead)
    "rare_store": [("    if (valid && l < left) {\n      const int64_t base",
                    "    if (valid && l < left && scale == 1234.5f) {\n"
                    "      const int64_t base")],
    "n1_no_fft": [("    if (it == rounds - 1) cluster_arrive();  // the last "
                   "remote read is done\n    mix_fft<N>(v, tk.l, table, inv);",
                   "    if (it == rounds - 1) cluster_arrive();  // the last "
                   "remote read is done")],
    "n2_no_fft": [("    mix_fft<N>(v, tk.l, table, inv);\n    if (valid) {",
                   "    if (valid) {")],
}
# the probes' results are wrong by design: only the timing is read
PROBES = {"rare_store", "n1_no_fft", "n2_no_fft"}

SHIM = """#include "mid_line.cuh"
namespace tpufft_mid {{
extern "C" int ab_launch_{f}(const void* xr, const void* xi, void* yr,
                            void* yi, const void* tw1, const void* tw2,
                            long long pre, int n1, int n2, long long L,
                            int csize, int bf16, int quads, int inverse,
                            float scale, void* stream) {{
  return launch_mixed_as<{f}>({{xr, xi, yr, yi, tw1, tw2, pre, n1, n2, L,
                                csize, bf16, quads, inverse, scale,
                                static_cast<cudaStream_t>(stream)}});
}}
extern "C" int ab_clusters_{f}(int n1, int n2, int csize, int* out) {{
  return mixed_clusters_as<{f}>(n1, n2, csize, out);
}}
}}
"""


def _family(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


def build(names: list[str], families: list[int]) -> dict:
    """Each variant's header and shims compiled and linked; name ->
    (library, ptxas report)."""
    header = open(HEADER).read()
    texts = {}
    for name in names:
        text = header
        for old, new in VARIANTS[name]:
            assert old in text, f"{name}: {old!r} not in the header"
            text = text.replace(old, new)
        texts[name] = {"mid_line.cuh": text,
                       **{f"mid_ab_{f}.cu": SHIM.format(f=f)
                          for f in families}}
    built = variant_build.build(OUT, None, texts, lambda f: False)
    return {name: (ctypes.CDLL(lib), log)
            for name, (lib, log) in built.items()}


def resources(log: str) -> str:
    """Registers and spill bytes of each mid_mixed_kernel in a ptxas
    report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w*mid_mixed_kernel\w*)'",
                      line)
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
            fam = re.search(r"ILi(\d+)E", cur).group(1)
            out.append(f"n1 family {fam}: {m.group(1)} registers, {spill} "
                       "bytes spilled")
            cur = None
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["tree"])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--shapes", nargs="*", default=None)
    args = ap.parse_args()
    names = ["tree"] + [v for v in args.variants if v != "tree"]
    shapes = SHAPES if args.shapes is None else tuple(
        tuple(int(v) for v in s.split(",")) for s in args.shapes)
    card = chip_smoke._smi("name,power.limit")
    families = sorted({_family(s[1]) for s in shapes})
    libs = build(names, families)
    for name, (_, log) in libs.items():
        print(f"{card}: {name}: ptxas {resources(log)}", flush=True)
    vp, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (lib, _) in libs.items():
        for f in families:
            fn = getattr(lib, f"ab_launch_{f}")
            fn.argtypes = [vp] * 6 + [ll, i32, i32, ll, i32, i32, i32, i32,
                                      ctypes.c_float, vp]
            fn.restype = i32
    rate = chip_smoke._copy_rate()
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for shape in shapes:
        pre, n1, n2, L = shape
        assert mid_pair_fft.form(n1, n2, L) == "mixed", shape
        c = mid_pair_fft.cluster_size(n1, n2)
        xr, xi = chip_smoke._device_planes(shape, seed=n1 + L)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        tw1 = minor_fft._device_twiddles(n1, False, xr.device)
        tw2 = minor_fft._device_twiddles(n2, False, xr.device)
        ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=False,
                                                  scale=1.0)
        quads = int(L % 4 == 0)
        f = _family(n1)

        def run(name):
            fn = getattr(libs[name][0], f"ab_launch_{f}")

            def go():
                err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                         yi.data_ptr(), tw1.data_ptr(), tw2.data_ptr(), pre,
                         n1, n2, L, c, 0, quads, 0, 1.0, stream)
                assert err == 0, (name, shape, err)
            return go

        for name in names:
            run(name)()
            torch.cuda.synchronize()
            if name in PROBES:
                continue
            err = chip_smoke.pair_err((yr, yi), ref)
            chip_smoke.check(err < chip_smoke.F32_TOL,
                             f"{name} {shape}: vs plain {err:.3e}")
        times = {name: [] for name in names}
        for _ in range(args.turns):
            for name in names[1:] or names:
                for who in ("tree", name, name, "tree"):
                    times[who].append(chip_smoke._time_ms(run(who)))
        med = {k: statistics.median(v) for k, v in times.items()}
        floor = 16.0 * xr.numel() / rate * 1e3
        print(f"{card}: K6 {shape} clusters of {c}: " + ", ".join(
            f"{k} {v:.4f} ({min(times[k]):.4f}-{max(times[k]):.4f})"
            for k, v in med.items()) + f" ms; floor {floor:.4f}", flush=True)
        result[str(shape)] = dict(med, floor=floor)
        del xr, xi, yr, yi, ref
    print(json.dumps(result))


if __name__ == "__main__":
    main()
