// Batched 2-D C2C FFT over the two trailing axes of (pre, n1, n2) planes,
// with plain C entry points for ctypes (tpufft_torch/kernels/pair_fft.py
// and fused_fft.py bind and check them).
//
// Replaces tpufft/kernels/mxu_fft.py:_build_2d, the Pallas TPU kernel that
// runs a plan's trailing pair of axes in one pass, and, on fused storage
// (tpufft_pair_fft_fused: (pre, n1, 2*n2), each n2-row [re | im]; only the
// load and the store differ), _build_pair_fused (K17). Contract as there: f32
// or bf16 storage, f32 arithmetic, a forward/inverse flag, one real scale
// applied once at the store, and n2_io's zero-pad direction (m_in < m_out =
// n2) as n2_in: the input slices are (n1, n2_in) and their columns n2_in..
// n2-1 load as zeros, so the pad never touches device memory. n2_io's crop
// direction (the adjoint) is not a forward path here: the backward of the
// padded pair is the full pair of the gradient, then a crop.
//
// What should bound it on an H100: device-memory bandwidth (~3 flop/byte
// per axis); run axis by axis, a 2-D transform reads and writes the planes
// twice, this kernel once. What does bound it is its stages: their
// registers (64 a thread at 1024 threads) and barriers (PERF.md). A block holds whole (n1, n2) slices in
// one shared tile (row-major, indexed through fft_stages.cuh's pad()) and
// runs two passes over it, each split among teams of warps that own whole
// lines and synchronise only among themselves (__syncwarp for a one-warp
// team, a named barrier otherwise); the one block barrier sits between
// the passes:
//   1. the n2 transforms of the rows. A team's first stage (radix 2, 4 or
//      8) reads its butterflies' inputs straight from device memory into
//      registers, consecutive threads on consecutive elements of a row (an
//      odd first radix copies the team's rows in first), and writes the
//      tile; the other stages run in place in the team's rows;
//   2. the n1 transforms of the columns, in place in the tile: consecutive
//      threads take one butterfly of consecutive columns, so every read
//      and write touches consecutive tile elements (no transpose, no bank
//      conflict at n1 or n2 a multiple of 16), and the last stage writes
//      its outputs from registers to device memory in natural (k1, k2)
//      order, a warp a run of consecutive k2 of one k1 row (128 bytes of
//      each plane where the team owns 32 columns or more).
// Every stage is the Stockham stage of fft_stages.cuh (its butterflies and
// odd-radix sums), with multiply-and-shift index division (Div). The
// slices are packed like the minor kernel's rows
// (minor_fft.cuh:launch_geometry): ~4096 elements to a 512-thread block
// (two blocks an SM), or one slice of up to 16384 elements (139 KB of
// shared memory, one block an SM) to a block of up to 1024 threads.
// Plans whose radices are all 2, 4 or 8 run an instantiation without the
// odd stages, whose registers otherwise spill in every stage. At 16384
// elements, forms that overlap one slice's loads with another's stages
// (a persistent grid, with or without L2 prefetch of the next slice; a
// slice split over a cluster of 2 or 4 blocks that share an SM) measured
// slower than this one (tools/pair_phases.py keeps them as patches).

#include <climits>

#include "team_stages.cuh"

using namespace tpufft_fft;
using namespace tpufft_team;
using tpufft_minor::Geometry;
using tpufft_minor::launch_geometry;

namespace {

// Block b transforms slices [b*slabs, b*slabs + slabs) of the planes; the
// ragged last block computes on zero slices and stores only real ones.
// kPadded: input slices are (n1, n2_in), zero-padded to (n1, n2) at the
// load; without it n2_in is unused. kFused (K17): the slices are fused
// storage, h = n2 (fft_stages.cuh). kOdd: a radix of n1 or n2 is odd
// (team_stages.cuh:team_pass). row_warps and col_warps: the warps of a
// team in the row and the column pass (team_stages.cuh:team_warps).
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused, bool kOdd>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi,
                const float2* __restrict__ tw1,
                const float2* __restrict__ tw2, int64_t pre, Radices plan1,
                Radices plan2, int slabs, int n2_in, int inverse,
                float scale, int row_warps, int col_warps) {
  static_assert(!(kPadded && kFused), "no fused zero-pad form");
  extern __shared__ float2 tpufft_pair_smem[];
  float2* buf = tpufft_pair_smem;
  const int n1 = plan1.n, n2 = plan2.n, area = n1 * n2;
  const int64_t s0 = (int64_t)blockIdx.x * slabs;
  const int here = (int)(pre - s0 < slabs ? pre - s0 : slabs);
  const int64_t base = s0 * area;
  const bool inv = inverse != 0;
  {  // the n2 transforms of the slabs * n1 rows
    const Team tm(row_warps);
    int l0, cnt;
    share(tm, slabs * n1, l0, cnt);
    if (cnt > 0) {
      const Lines<false> ln(l0, cnt, n2, n2, area);
      const auto load = [&](int r, int i) {
        float2 v = make_float2(0.f, 0.f);
        if (r < here * n1) {
          int64_t g;
          if (kPadded) {
            g = (s0 * n1 + r) * n2_in + i;
            if (i >= n2_in) return v;
          } else {
            g = base + (int64_t)r * n2 + i;
            if (kFused) g = fused_index(g, i);
          }
          v = make_float2(load_f(xr, g), load_f(xi, g));
        }
        return v;
      };
      const int r0 = plan2.r[0];
      const bool from_tile = kOdd && r0 != 8 && r0 != 4 && r0 != 2;
      if (from_tile) {  // an odd first radix reads each input r times
        const Div by_n(n2);
        for (int e = tm.rank; e < cnt * n2; e += tm.size) {
          const int l = by_n(e), i = e - l * n2;
          buf[pad(ln.base(l) + i)] = load(l0 + l, i);
        }
        tm.sync();
      }
      team_pass<kPer, kOdd>(buf, tw2, plan2, ln, inv, from_tile, tm,
                            load, [](int, int, float2) {});
    }
  }
  __syncthreads();
  {  // the n1 transforms of the slabs * n2 columns, stored from registers
    const Team tm(col_warps);
    int l0, cnt;
    share(tm, slabs * n2, l0, cnt);
    if (cnt > 0) {
      const Lines<true> ln(l0, cnt, n1, n2, area);
      const auto store = [&](int c, int k1, float2 w) {
        const int slice = ln.by_n2(c), k2 = c - slice * n2;
        if (slice >= here) return;
        int64_t g = base + (int64_t)slice * area + k1 * n2 + k2;
        if (kFused) g = fused_index(g, k2);
        store_f(yr, g, w.x * scale);
        store_f(yi, g, w.y * scale);
      };
      team_pass<kPer, kOdd>(
          buf, tw1, plan1, ln, inv, true, tm,
          [](int, int) { return make_float2(0.f, 0.f); }, store);
    }
  }
}

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused, bool kOdd>
int launch(const void* xr, const void* xi, void* yr, void* yi,
           const void* tw1, const void* tw2, long long pre,
           const Radices& plan1, const Radices& plan2, const Geometry& g,
           int n2_in, int inverse, float scale, cudaStream_t stream) {
  auto* kernel = pair_fft_kernel<T, kThreads, kPer, kMinBlocks, kPadded,
                                 kFused, kOdd>;
  if (g.threads > kThreads || g.per != kPer) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (pre + g.rows - 1) / g.rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int W = g.threads / 32;
  const int row_warps = team_warps(W, g.rows * plan1.n, plan2.n, kPer, false);
  const int col_warps = team_warps(W, g.rows * plan2.n, plan1.n, kPer, true);
  kernel<<<(unsigned)blocks, g.threads, g.smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(yr), static_cast<T*>(yi),
      static_cast<const float2*>(tw1), static_cast<const float2*>(tw2),
      (int64_t)pre, plan1, plan2, g.rows, n2_in, inverse, scale, row_warps,
      col_warps);
  return (int)cudaGetLastError();
}

template <typename T, bool kPadded, bool kFused, bool kOdd>
int launch_sized(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw1, const void* tw2, long long pre,
                 const Radices& plan1, const Radices& plan2, int n2_in,
                 int inverse, float scale, cudaStream_t stream) {
  const Geometry g = launch_geometry(plan1.n * plan2.n);
  if (g.per == 8)
    return launch<T, 512, 8, 2, kPadded, kFused, kOdd>(
        xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2, g, n2_in, inverse,
        scale, stream);
  return launch<T, 1024, 16, 1, kPadded, kFused, kOdd>(
      xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2, g, n2_in, inverse, scale,
      stream);
}

inline bool has_odd(const Radices& plan) {
  for (int t = 0; t < plan.count; ++t)
    if (plan.r[t] % 2) return true;
  return false;
}

// The kernel for the storage and for the radices: with an odd one, or
// with 2, 4 and 8 only (no odd stage compiled).
template <typename T, bool kPadded, bool kFused>
int launch_plans(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw1, const void* tw2, long long pre,
                 const Radices& plan1, const Radices& plan2, int n2_in,
                 int inverse, float scale, cudaStream_t stream) {
  if (has_odd(plan1) || has_odd(plan2))
    return launch_sized<T, kPadded, kFused, true>(
        xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2, n2_in, inverse, scale,
        stream);
  return launch_sized<T, kPadded, kFused, false>(
      xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2, n2_in, inverse, scale,
      stream);
}

template <typename T>
int launch_typed(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw1, const void* tw2, long long pre,
                 const Radices& plan1, const Radices& plan2, int n2_in,
                 int inverse, float scale, cudaStream_t stream) {
  if (n2_in == plan2.n)
    return launch_plans<T, false, false>(xr, xi, yr, yi, tw1, tw2, pre,
                                         plan1, plan2, n2_in, inverse, scale,
                                         stream);
  return launch_plans<T, true, false>(xr, xi, yr, yi, tw1, tw2, pre, plan1,
                                      plan2, n2_in, inverse, scale, stream);
}

// K17: (pre, n1, 2*n2) fused storage, its two planes st and st + n2 (out
// and out + n2) with row stride 2*n2.
template <typename T>
int launch_fused(const void* st, void* out, const void* tw1, const void* tw2,
                 long long pre, const Radices& plan1, const Radices& plan2,
                 int inverse, float scale, cudaStream_t stream) {
  const T* x = static_cast<const T*>(st);
  T* y = static_cast<T*>(out);
  const int n2 = plan2.n;
  return launch_plans<T, false, true>(x, x + n2, y, y + n2, tw1, tw2, pre,
                                      plan1, plan2, n2, inverse, scale,
                                      stream);
}

}  // namespace

// Transforms both trailing axes of the (pre, n1, n2_in) planes xr/xi,
// zero-padded along the last axis to n2, into the (pre, n1, n2) planes
// yr/yi (f32, or bf16 when bf16 != 0) on `stream`, a stream of the current
// device; n2_in == n2 is the plain pair transform. tw1 and tw2 hold
// exp(-+2 pi i k / n1) and exp(-+2 pi i k / n2) as complex f32 for the
// direction; rad1 and rad2 multiply to n1 and n2, each radix 2, 4, 8 or an
// odd value up to 127; n1, n2 >= 2, 1 <= n2_in <= n2 and n1 * n2 <= 16384.
// Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_pair_fft(const void* xr, const void* xi, void* yr,
                               void* yi, const void* tw1, const void* tw2,
                               long long pre, int n1, int n2, int n2_in,
                               const int* rad1, int nstages1,
                               const int* rad2, int nstages2, int inverse,
                               float scale, int bf16, void* stream) {
  Radices plan1, plan2;
  if (pre < 0 || n1 < 2 || n2 < 2 || (long long)n1 * n2 > kMaxN ||
      n2_in < 1 || n2_in > n2 ||
      !make_radices(n1, rad1, nstages1, &plan1) ||
      !make_radices(n2, rad2, nstages2, &plan2))
    return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(xr, xi, yr, yi, tw1, tw2, pre, plan1,
                                       plan2, n2_in, inverse, scale, s);
  return launch_typed<float>(xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2,
                             n2_in, inverse, scale, s);
}

// K17: both trailing logical axes of the (pre, n1, 2*n2) array st in fused
// storage, each n2-row [re(0..n2-1) | im(0..n2-1)], into `out` of the same
// shape; every other argument and condition as for tpufft_pair_fft with
// n2_in = n2. Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_pair_fft_fused(const void* st, void* out,
                                     const void* tw1, const void* tw2,
                                     long long pre, int n1, int n2,
                                     const int* rad1, int nstages1,
                                     const int* rad2, int nstages2,
                                     int inverse, float scale, int bf16,
                                     void* stream) {
  Radices plan1, plan2;
  if (pre < 0 || n1 < 2 || n2 < 2 || (long long)n1 * n2 > kMaxN ||
      !make_radices(n1, rad1, nstages1, &plan1) ||
      !make_radices(n2, rad2, nstages2, &plan2))
    return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fused<__nv_bfloat16>(st, out, tw1, tw2, pre, plan1, plan2,
                                       inverse, scale, s);
  return launch_fused<float>(st, out, tw1, tw2, pre, plan1, plan2, inverse,
                             scale, s);
}
