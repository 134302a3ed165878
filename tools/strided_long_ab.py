"""The cluster line form of the strided kernel (K2, K3, K18, K19) above
n = 2048 (bf16 from 1080) on the card: held against its plain versions,
timed beside the stage form it replaced, and beside the designs it did not
take.

Run from the repository root on a machine with the GPU:

    python3 tools/strided_long_ab.py [--check] [--times] [--variants]
                                     [--only NAME,...] [--turns N]

``--check``: at every length of the cluster form's lists (f32 above 2048
and bf16; ``CLUSTER`` of ``tests/test_torch_strided_geometry.py``)
the library's geometry (``inner_fft.line_geometry``) equals the model's,
and K2, K3 (with and without the (n, M) twiddle), K18 (M = 3) and K19 (M =
1) meet their plain versions on (2, n, C + 1) and (1, n, 241) (f32 1e-5,
bf16 8e-3; forward and inverse); each length is printed with the clusters
the card holds at once (``cudaOccupancyMaxActiveClusters``, from a query of
the tool's own built into ``build/strided_long_ab/occupancy/``) and
ptxas's registers and spills of its K2 kernel.

``--times``: ``chip_smoke.py`` phase 30's rows by CUDA events (median of
20 after two warm-up calls): K2 (1, 3840, 2160), (1, 8192, 8192), (2,
16384, 2048) in f32, K3 with the two-pass twiddle at 4096 on (4 x 4096,
4096, 1) and K2 (8, 2048, 2048) in bf16, the cluster form and the stage
form (``stages=True``) in turns (cluster, stages, stages, cluster;
``--turns`` times), then the library call (``torch.fft.fft``), the plain
version and a device copy of the same bytes (the floor); then the paths
``fft2`` (1, 3840, 2160) and ``fft`` (4, 2**24) beside ``torch.fft``.

``--variants``: patched copies of the strided sources
(``strided_fft.cu`` and ``strided_long*.cu*``, f32 kernels only; the line
form's sources are built once), one nvcc a source, twelve at a time,
linked into ``build/strided_long_ab/<name>/``:

- ``two``: two tile buffers a block, used in turn (one cluster barrier a
  unit, twice the tile);
- ``qdouble``: every length's cluster twice as large where N1 allows it
  (Q = 4 -> 8 at 3840, 8 -> 16 at 8192), half the tile a block;
- ``qhalf``: every cluster half as large (one block an SM where two fit
  before);
- ``twfirst``: K3's pass 3 reading the N3 twiddles of a line into
  registers before its DFT, not at each store;
- ``c32``: units of 32 columns (128-byte f32 rows, 64-byte bf16 rows),
  clusters twice as large where N1 allows it (f32 and bf16 kernels);
- the probes ``local`` (pass 1 writes its own tile instead of the
  owner's: no distributed shared memory), ``local_nosync`` (that, and
  block barriers for the cluster barriers), ``noload`` (pass 1 loads
  nothing: its registers come from the addresses) and ``nostore`` (pass
  3 stores nothing), timed only: their results are wrong.

Each but the probes is held against the plain version, and each is timed
in turns against the tree's library at (1, 3840, 2160), (1, 8192, 8192),
(2, 16384, 2048), K3 with the two-pass twiddle on (4 x 4096, 4096, 1) and
(``tree`` and ``c32`` only) bf16 (8, 2048, 2048); ``--only`` builds the
variants named;
its geometry is read from its own library. Design (b), two launches of the
four-step line form (K3's line form at N1 over M post columns with w^(k1
m) at its store, then K2's at M), is timed beside them at the same shapes
(N1 x M = 60 x 64, 64 x 128, 128 x 128): its second launch stores in (k1,
k2) order, checked against the plain version through a permuted view; the
digit swap folded into its stores would change only which whole rows of
post columns a store writes. Every line names the card and its power
limit; ``--times`` ends with a JSON object of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import tpufft_torch  # noqa: E402
from test_torch_strided_geometry import (CLUSTER,  # noqa: E402
                                         LONG_F32_ABOVE, model_geometry)
from tools import ptxas_compare, variant_build  # noqa: E402
from tpufft_torch import _build  # noqa: E402
from tpufft_torch.kernels import fused_fft, inner_fft, minor_fft  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 8e-3
RATE = [0.0]  # the card's copy rate, bytes/s, measured at the start
SRC_DIR = "tpufft_torch/csrc"
OUT = "build/strided_long_ab"
NVCC_JOBS = 12  # nvcc processes at once (each takes 1-2 GB)
# the prediction's K2 shapes (f32), and design (b)'s split of each n
K2_SHAPES = ((1, 3840, 2160), (1, 8192, 8192), (2, 16384, 2048))
SPLIT_B = {3840: (60, 64), 8192: (64, 128), 16384: (128, 128)}
# clusters the card holds at once of each length's K2 kernel (f32, bf16)
OCCUPANCY = """#include "strided_long.cuh"

namespace tpufft_strided {

template <typename T, typename S>
int occupancy_of(const ClusterGeometry& g, int* out) {
  auto* kernel = strided_cluster_kernel<T, S, false, false>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      cluster_config(kernel, g.threads, g.smem, g.q, g.q, 0, &attr, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
  return (int)err;
}

#define TPUFFT_OCCUPANCY(n_, n1, n2, n3, q, th)                          \\
  if (n == n_) return occupancy_of<T, ClusterStep<n1, n2, n3, q, th>>(g, out);

template <typename T>
int occupancy(int n, int* out) {
  ClusterGeometry g;
  if (!cluster_geometry(n, 1 << 20, std::is_same<T, __nv_bfloat16>::value,
                        &g))
    return (int)cudaErrorInvalidValue;
  TPUFFT_STRIDED_LONG_A(TPUFFT_OCCUPANCY)
  TPUFFT_STRIDED_LONG_B(TPUFFT_OCCUPANCY)
  return (int)cudaErrorInvalidValue;
}

}  // namespace tpufft_strided

extern "C" int tpufft_cluster_occupancy(int n, int bf16, int* out) {
  return bf16 ? tpufft_strided::occupancy<__nv_bfloat16>(n, out)
              : tpufft_strided::occupancy<float>(n, out);
}
"""
LIST_ROW = re.compile(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)")


def _kw(inverse=False, n=1):
    return dict(inverse=inverse, scale=1.0 / n if inverse else 1.0)


def _hold(what, got, ref, dtype):
    err = chip_smoke.pair_err(got, ref)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    chip_smoke.check(err < tol, f"{what}: {err:.3e} >= {tol}")
    return err


def report(text: str) -> dict:
    """ptxas's (registers, spill stores) of each strided_cluster_kernel in
    a build log, by its name (tools/ptxas_compare.py demangles it)."""
    rows = ptxas_compare._report(text)
    return {ptxas_compare._key(k).replace("tpufft_strided::", ""): v[:2]
            for k, v in rows.items() if "strided_cluster_kernel" in k}


def _kernel_line(ptxas: dict, n: int, dtype: str) -> str:
    """The K2 (plain, not fused, no tw_nm) kernel's ptxas numbers at n."""
    t = "float" if dtype == "f32" else "__nv_bfloat16"
    for k, (regs, spills) in ptxas.items():
        m = re.search(r"ClusterStep<(\d+), (\d+), (\d+),", k)
        if (m and int(m[1]) * int(m[2]) * int(m[3]) == n
                and k.split("<", 1)[1].startswith(t)
                and k.endswith("false, false>")):
            return f"{regs} registers, {spills} bytes spilled"
    return "not found"


def occupancy_lib():
    """``OCCUPANCY`` built against the tree's ``strided_long.cuh`` into
    ``build/strided_long_ab/occupancy/``: its query."""
    out = os.path.join(OUT, "occupancy")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "occupancy.cu")
    with open(src, "w") as f:
        f.write(OCCUPANCY)
    lib = os.path.abspath(os.path.join(out, "lib.so"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-I", SRC_DIR,
                    "-shared", "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).tpufft_cluster_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def check() -> None:
    log = _build.build().with_suffix(".log").read_text()
    ptxas = report(log)
    print("ptxas, cluster kernels (registers, spill stores): "
          + "; ".join(f"{k}: {v}" for k, v in sorted(ptxas.items())),
          flush=True)
    occupancy = occupancy_lib()
    for dtype, ns in ((torch.float32,
                       [n for n in sorted(CLUSTER) if n > LONG_F32_ABOVE]),
                      (torch.bfloat16, sorted(CLUSTER))):
        key = "f32" if dtype == torch.float32 else "bf16"
        cols = 16 if dtype == torch.bfloat16 else 8
        for n in ns:
            for post in (cols - 1, cols, 241):
                got = inner_fft.line_geometry(n, post, dtype)
                want = model_geometry(n, post, dtype == torch.bfloat16)
                chip_smoke.check(got == want,
                                 f"{key} n={n} post={post}: library {got}, "
                                 f"model {want}")
            worst = 0.0
            for pre, post in ((2, cols + 1), (1, 241)):
                xr, xi = chip_smoke._planes((pre, n, post), dtype,
                                            seed=n + post)
                M = next(m for m in (5, 3, 2, 1) if post % m == 0)
                tw = chip_smoke._twiddle(n, M, seed=n)
                v = (pre * n, M, post // M)
                for inverse in (False, True):
                    kw = _kw(inverse, n)
                    what = f"{key} n={n} {(pre, n, post)} {kw}"
                    worst = max(worst, _hold(
                        f"K2 {what}", inner_fft.fft_inner(xr, xi, **kw),
                        inner_fft.fft_inner_reference(xr, xi, **kw), dtype))
                    for twiddle in (None, tw):
                        a = dict(kw, n=n, twiddle=twiddle)
                        worst = max(worst, _hold(
                            f"K3 {what} tw={twiddle is not None}",
                            inner_fft.fft_inner_nd(xr.reshape(v),
                                                   xi.reshape(v), **a),
                            inner_fft.fft_inner_nd_reference(
                                xr.reshape(v), xi.reshape(v), **a), dtype))
                    for M in (1, 3):
                        st = torch.cat([xr, xi], -1).reshape(
                            pre, n, 1, 2 * post).repeat(1, 1, M, 1)
                        out = fused_fft.fft_inner_fused(st, **kw)
                        ref = fused_fft.fft_inner_fused_reference(st, **kw)
                        worst = max(worst, _hold(
                            f"K{19 if M == 1 else 18} {what}",
                            (out[..., :post], out[..., post:]),
                            (ref[..., :post], ref[..., post:]), dtype))
            torch.cuda.synchronize()
            resident = ctypes.c_int(0)
            err = occupancy(n, int(dtype == torch.bfloat16),
                            ctypes.byref(resident))
            chip_smoke.check(err == 0, f"occupancy at {n}: CUDA error {err}")
            geo = inner_fft.line_geometry(n, 241, dtype)
            print(f"  {key} n={n} {geo}: clusters resident "
                  f"{resident.value} ({resident.value * geo['q']} blocks); "
                  f"ptxas {_kernel_line(ptxas, n, key)}; max normalized "
                  f"error {worst:.3e}", flush=True)


def _turns(fns: dict, turns: int) -> dict:
    """Each callable timed in turns a, b, b, a (``turns`` rounds); the
    median of each one's medians, and its range."""
    got = {k: [] for k in fns}
    keys = list(fns)
    for _ in range(turns):
        for k in keys + keys[::-1]:
            got[k].append(chip_smoke._time_ms(fns[k]))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def _show(label, t, card, extra=""):
    print(f"{label} [{card}]: " + ", ".join(
        f"{k} " + "/".join(f"{x:.4f}" for x in v) for k, v in t.items())
        + extra, flush=True)


def _k3_two_pass_inputs():
    """K3's operands in the two-pass ``fft`` of (4, 2**24): the (4 x
    4096, 4096, 1) view and the (4096, 4096) twiddle it stores with."""
    from tpufft_torch import execute
    xr, xi = chip_smoke._device_planes((4 * 4096, 4096, 1), seed=24)
    tw = execute._device_two_pass_twiddle(4096, 4096, False, xr.device)
    return xr, xi, tw


def times(turns: int, card: str) -> dict:
    out = {}
    rows = [(f"K2 {shape} f32", shape, torch.float32, None)
            for shape in K2_SHAPES]
    rows.insert(3, ("K3 + twiddle (4 x 4096, 4096, 1) f32", None,
                    torch.float32, "k3"))
    rows.append(("K2 (8, 2048, 2048) bf16", (8, 2048, 2048),
                 torch.bfloat16, None))
    for label, shape, dtype, kind in rows:
        if kind == "k3":
            xr, xi, tw = _k3_two_pass_inputs()
            n, kw = 4096, dict(n=4096, inverse=False, scale=1.0, twiddle=tw)
            fast = lambda: inner_fft.fft_inner_nd(xr, xi, **kw)  # noqa
            slow = lambda: inner_fft._launch(  # noqa: E731
                xr, xi, 4, 4096, 4096, False, 1.0, tw, 1, stages=True)[:2]
            plain = lambda: inner_fft.fft_inner_nd_reference(  # noqa
                xr, xi, **kw)
            xc = torch.complex(xr, xi).reshape(4, 4096, 4096)
            lib = lambda: torch.fft.fft(xc, dim=1)  # noqa: E731
            post = 4096
        else:
            pre, n, post = shape
            xr, xi = chip_smoke._device_planes(shape, seed=n)
            if dtype == torch.bfloat16:
                xr, xi = xr.to(dtype), xi.to(dtype)
            kw = dict(inverse=False, scale=1.0)
            fast = lambda: inner_fft.fft_inner(xr, xi, **kw)  # noqa: E731
            slow = lambda: inner_fft.fft_inner(  # noqa: E731
                xr, xi, stages=True, **kw)
            plain = lambda: inner_fft.fft_inner_reference(  # noqa: E731
                xr, xi, **kw)
            xc = torch.complex(xr.float(), xi.float())
            lib = lambda: torch.fft.fft(xc, dim=1)  # noqa: E731
        geo = inner_fft.line_geometry(n, post, dtype)
        chip_smoke.check(geo is not None and "q" in geo,
                         f"{label}: not on the cluster form ({geo})")
        a, b = fast(), slow()
        err = chip_smoke.pair_err(a, b)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        chip_smoke.check(err < tol, f"{label}: cluster vs stages {err:.3e}")
        del a, b
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        t = _turns({"cluster": fast, "stages": slow}, turns)
        t["torch_fft"] = (chip_smoke._time_ms(lib),)
        t["plain"] = (chip_smoke._time_ms(plain),)
        t["copy"] = (chip_smoke._time_ms(
            lambda: (yr.copy_(xr), yi.copy_(xi))),)
        nbytes = 2 * 2 * xr.numel() * xr.element_size()
        bound = nbytes / RATE[0] * 1e3
        _show(f"{label} Q={geo['q']} split {geo['n1']} x {geo['n2']} x "
              f"{geo['n3']}", t, card,
              f"; bound {bound:.4f} ({nbytes / 1e9:.3f} GB); cluster vs "
              f"stages {err:.3e}")
        out[label] = dict({k: v[0] for k, v in t.items()}, bound=bound)
        del xr, xi, xc, yr, yi
    for label, shape, call, ref in (
            ("fft2 (1, 3840, 2160)", (1, 3840, 2160), tpufft_torch.fft2,
             torch.fft.fft2),
            ("fft (4, 2**24)", (4, 1 << 24), tpufft_torch.fft,
             torch.fft.fft)):
        xr, xi = chip_smoke._device_planes(shape, seed=sum(shape))
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        t = {"path": (chip_smoke._time_ms(lambda: call(x)),),
             "torch_fft": (chip_smoke._time_ms(lambda: ref(xc)),)}
        _show(f"path {label} c64", t, card)
        out[f"path {label}"] = {k: v[0] for k, v in t.items()}
        del x, xr, xi, xc
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------

def _relist(text: str, q_of) -> str:
    """The cluster lists with each row's Q replaced by q_of(N1, M, Q)."""
    def sub(m):
        n, n1, n2, n3, q, th = map(int, m.groups())
        return f"X({n}, {n1}, {n2}, {n3}, {q_of(n1, n2 * n3, q)}, {th})"
    return LIST_ROW.sub(sub, text)


def _f32_only(text: str) -> str:
    """The header with no bf16 kernel instantiated (the variants are timed
    in f32)."""
    return _patch(text, (("if constexpr (kBf16 || n_ > kLongF32Above)",
                          "if constexpr (!kBf16 && n_ > kLongF32Above)"),))


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        assert text.count(old) == 1, f"marker not unique: {old!r}"
        text = text.replace(old, new)
    return text


# Probes: timed only, their results are wrong.
PROBES = ("local", "local_nosync", "noload", "nostore")
# the variants built with their bf16 kernels (the others f32 only)
BF16_VARIANTS = ("tree", "c32")


def variants() -> dict:
    cuh = open(os.path.join(SRC_DIR, "strided_long.cuh")).read()
    assert len(LIST_ROW.findall(cuh)) == 20
    fits = lambda n1, m, q: n1 % q == 0 and (16 * m) % q == 0  # noqa: E731
    local = ("float2* dst = cluster.map_shared_rank(tile, k1 / K);",
             "float2* dst = tile;")
    texts = {
        "two": _patch(cuh, (
            ("const int tile = (n1 / q) * n2 * n3 * kLongCols;",
             "const int tile = 2 * (n1 / q) * n2 * n3 * kLongCols;"),
            ("smem == (table + tile) * sizeof(float2)",
             "smem == (table + 2 * tile) * sizeof(float2)"),
            ("  float2* const tile = table + S::table;\n", ""),
            ("u < units; u += clusters) {",
             "u < units; u += clusters, ++turn) {\n    float2* const tile "
             "= table + S::table + (turn & 1) * S::tile;"),
            ("  long_arrive();  // this block has started\n",
             "  long_arrive();  // this block has started\n  int turn = 0;\n"),
            ("if (r == 0) long_wait();", "if (r == 0 && turn == 0) "
             "long_wait();"),
            ("    long_arrive();  // this block's tile is read\n", ""),
            ("  long_wait();\n}", "  if (turn == 0) long_wait();\n}"))),
        "qdouble": _relist(cuh, lambda n1, m, q: 2 * q if (
            2 * q <= 16 and fits(n1, m, 2 * q)) else q),
        "qhalf": _relist(cuh, lambda n1, m, q: max(1, q // 2)),
        "local": _patch(cuh, (local,)),
        "local_nosync": _patch(cuh, (local, (
            'asm volatile("barrier.cluster.arrive.release;" ::: "memory");',
            ""), (
            'asm volatile("barrier.cluster.wait.acquire;" ::: "memory");',
            "__syncthreads();"))),
    }
    # phase probes: no device load in pass 1 (registers from the address),
    # no store in pass 3
    texts["noload"] = _patch(cuh, ((
        "v[h][j] = live ? make_float2(load_f(xr, g), load_f(xi, g))",
        "v[h][j] = live ? make_float2(__int_as_float((int)g & 0x3fffff), "
        "0.f)"),))
    texts["nostore"] = _patch(cuh, ((
        "          if (live)\n            store_out<kTw>(",
        "          if (live && scale == -12345.f)\n"
        "            store_out<kTw>("),))
    # K3: the N3 twiddles of a pass-3 line read into registers before its
    # DFT, not at each store
    texts["twfirst"] = _patch(cuh, ((
        """        const int cq = kTw ? col / tw_l : 0;
        long_line<N3, S::emit3>(v[h], table + S::w3, inv,
                                [&](int k3, float2 y) {
          if (live)
            store_out<kTw>(yr, yi, tw_nm,
                           g0 + (int64_t)(N1 * N2 * k3) * stride,
                           k0 + N1 * N2 * k3, tw_m, cq, y, scale);""",
        """        const int cq = kTw ? col / tw_l : 0;
        float2 twv[kTw ? N3 : 1];
        if constexpr (kTw) {
#pragma unroll
          for (int k3 = 0; k3 < N3; ++k3)
            twv[k3] = live ? __ldg(&tw_nm[(int64_t)(k0 + N1 * N2 * k3) *
                                              tw_m + cq])
                           : make_float2(0.f, 0.f);
        }
        long_line<N3, S::emit3>(v[h], table + S::w3, inv,
                                [&](int k3, float2 y) {
          if (live)
            store_out<false>(yr, yi, tw_nm,
                             g0 + (int64_t)(N1 * N2 * k3) * stride,
                             k0 + N1 * N2 * k3, tw_m, cq,
                             kTw ? cmul(y, twv[k3]) : y, scale);"""),))
    texts = {k: _f32_only(v) for k, v in texts.items()}
    # units of 32 columns (128-byte f32, 64-byte bf16 rows), clusters
    # twice as large where N1 allows it (else twice the tile a block, or
    # the stage form where that leaves the shared memory)
    texts["c32"] = _patch(_relist(cuh, lambda n1, m, q: 2 * q if (
        2 * q <= 16 and fits(n1, m, 2 * q)) else q), (
        ("constexpr int kLongCols = 16;", "constexpr int kLongCols = 32;"),
        ("static constexpr int cols_log2 = 4;",
         "static constexpr int cols_log2 = 5;")))
    return texts


def build(texts: dict) -> dict:
    """The line form's sources once (they do not include the cluster
    header), then each variant's strided_fft.cu and cluster sources, one
    nvcc a source, at most NVCC_JOBS at a time; one link a variant; the
    library paths."""
    t0 = time.perf_counter()
    built = variant_build.build(
        OUT, "strided_long.cuh", texts,
        lambda f: f == "strided_fft.cu" or (f.startswith("strided_long_")
                                            and f.endswith(".cu")),
        shared=lambda f: (f.startswith("strided_line_")
                          and f.endswith(".cu")),
        jobs=NVCC_JOBS)
    for name, (_, log) in built.items():
        ptx = report(log)
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s; ptxas "
              f"(f32 K2 kernels): " + "; ".join(
                  f"{n}: {_kernel_line(ptx, n, 'f32')}"
                  for _, n, _ in K2_SHAPES), flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def _geometry(lib, n: int, post: int, bf16: bool) -> dict | None:
    out = (ctypes.c_int * 7)()
    kind = lib.tpufft_strided_line_geometry(n, ctypes.c_longlong(post),
                                            int(bf16), out)
    if kind != 2:
        return None
    return dict(zip(("n1", "n2", "cols", "threads", "smem", "n3", "q"), out))


def _shape(g: dict | None):
    """(Q, threads, shared memory, C) of a cluster geometry, or None."""
    return g and (g["q"], g["threads"], g["smem"], g["cols"])


def _entry(lib, xr, xi, yr, yi, pre, n, post, tw=None, tw_l=0):
    """A call of ``lib``'s strided entry point on the (pre, n, post) view
    of the planes (K3's with ``tw``)."""
    fn = lib.tpufft_strided_fft
    fn.argtypes = _build.load().tpufft_strided_fft.argtypes
    fn.restype = ctypes.c_int
    rad = minor_fft.radices(n)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    w = minor_fft._device_twiddles(n, False, xr.device)
    stream = torch.cuda.current_stream().cuda_stream
    tw_m = 0 if tw is None else tw.shape[1]
    bf16 = int(xr.dtype == torch.bfloat16)

    def run():
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 w.data_ptr(), pre, n, post, rad_arr, len(rad),
                 None if tw is None else tw.data_ptr(), tw_m, tw_l, 0, 1.0,
                 bf16, stream)
        assert err == 0, err
    return run


def _design_b(xr, xi, pre, n, post):
    """Design (b) at n = N1 M (``SPLIT_B``): K3's line form at N1 over M
    post columns with w^(k1 m) at its store, then K2's line form at M on
    (pre N1, M, post); returns the runner and its output planes, which
    hold X[k1 + N1 k2] at (p, k1, k2, c)."""
    n1, m = SPLIT_B[n]
    k = np.outer(np.arange(n1), np.arange(m)) * (-2.0 * np.pi / n)
    tw = torch.from_numpy(np.stack([np.cos(k), np.sin(k)], -1)
                          .astype(np.float32)).cuda()
    tree = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    zr, zi = torch.empty_like(xr), torch.empty_like(xi)
    first = _entry(tree, xr, xi, yr, yi, pre, n1, m * post, tw, post)
    second = _entry(tree, yr, yi, zr, zi, pre * n1, m, post)
    for length, cols in ((n1, m * post), (m, post)):
        chip_smoke.check(inner_fft.form(length, cols, torch.float32)
                         == "lines", f"design (b) at {length}: stage form")

    def run():
        first()
        second()
    return run, zr, zi


def compare_variants(turns: int, card: str, only: str) -> None:
    texts = variants()
    if only:
        texts = {k: v for k, v in texts.items() if k in only.split(",")}
    libs = {k: ctypes.CDLL(v) for k, v in build(texts).items()}
    tree = _build.load()
    from tpufft_torch import execute
    cases = [(f"K2 {shape}", shape, None, torch.float32)
             for shape in K2_SHAPES]
    cases.append(("K3 + twiddle (4 x 4096, 4096, 1)", (4, 4096, 4096),
                  execute._device_two_pass_twiddle(4096, 4096, False,
                                                   torch.device("cuda")),
                  torch.float32))
    cases.append(("K2 (8, 2048, 2048) bf16", (8, 2048, 2048), None,
                  torch.bfloat16))
    for label, (pre, n, post), tw, dtype in cases:
        bf16 = dtype == torch.bfloat16
        xr, xi = chip_smoke._device_planes((pre, n, post), seed=n)
        xr, xi = xr.to(dtype), xi.to(dtype)
        a = dict(tw=tw, tw_l=1) if tw is not None else {}
        if tw is None:
            ref = inner_fft.fft_inner_reference(
                xr[:1, :, :64], xi[:1, :, :64], inverse=False, scale=1.0)
        else:
            ref = inner_fft.fft_inner_nd_reference(
                xr[:1, :, :64].reshape(n, 64, 1),
                xi[:1, :, :64].reshape(n, 64, 1), n=n, inverse=False,
                scale=1.0, twiddle=tw[:, :64].contiguous())
            ref = tuple(t.reshape(1, n, 64) for t in ref)
        fns, errs, geos, outs = {}, {}, {}, []
        for name, lib in [("tree", tree), *libs.items()]:
            if bf16 and name not in BF16_VARIANTS:
                continue
            geos[name] = _geometry(lib, n, post, bf16)
            ya, yb = torch.empty_like(xr), torch.empty_like(xi)
            run = _entry(lib, xr, xi, ya, yb, pre, n, post, **a)
            run()
            if name not in PROBES:
                errs[name] = chip_smoke.pair_err(
                    (ya[:1, :, :64], yb[:1, :, :64]), ref)
            fns[name] = run
            outs.append((ya, yb))
        if tw is None:   # the tree's kernel through its wrapper
            fns["wrapper"] = lambda: inner_fft.fft_inner(
                xr, xi, inverse=False, scale=1.0)
        if n in SPLIT_B and tw is None and not bf16:
            run_b, zr, zi = _design_b(xr, xi, pre, n, post)
            run_b()
            n1, m = SPLIT_B[n]
            swap = tuple(t.reshape(pre, n1, m, post).transpose(1, 2)
                         .reshape(pre, n, post)[:1, :, :64] for t in (zr, zi))
            errs["design_b"] = chip_smoke.pair_err(swap, ref)
            fns["design_b"] = run_b
            outs.append((zr, zi))
        for k, e in errs.items():
            chip_smoke.check(e < (BF16_TOL if bf16 else F32_TOL),
                             f"{k} at {label}: {e:.3e}")
        t = _turns(fns, turns)
        nbytes = (4.0 * xr.element_size() * pre * n * post
                  + (0 if tw is None else 8.0 * n * post))
        bound = nbytes / RATE[0] * 1e3
        _show(f"variants {label}", t, card,
              f"; bound {bound:.4f}; geometries (Q, threads, smem, C) "
              + ", ".join(f"{k} {_shape(g)}" for k, g in geos.items())
              + f", design (b) {SPLIT_B.get(n)}; probes (timed only) "
              f"{', '.join(PROBES)}; vs plain "
              + ", ".join(f"{k} {e:.1e}" for k, e in errs.items()))
        del xr, xi, outs, ref


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    args = ap.parse_args()
    chip_smoke.phase_device()
    card = chip_smoke._smi("name,power.limit")
    chip_smoke.phase_build()
    RATE[0] = chip_smoke._copy_rate()
    if args.check:
        check()
    if args.times:
        print(json.dumps(times(args.turns, card)))
    if args.variants:
        compare_variants(args.turns, card, args.only)


if __name__ == "__main__":
    main()
