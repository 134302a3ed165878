// The mid-pair kernel's (K6) tile, its load, and its generic-radix cluster
// line form (mid_mixed_kernel). cluster_fft.cu picks the form and holds
// the power-of-two line form (mid_pair_line_kernel, on this tile and load)
// and the stage form; mid_line_{pow2,r3,r5,r7,r15}.cu instantiate this
// header's kernel, one source per radix family of n1, so that nvcc builds
// them in parallel.
//
// Replaces tpufft/kernels/mxu_fft.py:_build_mid_pair with its contract:
// axes 1 and 2 of (pre, n1, n2, L) planes in one pass, f32 or bf16
// storage, f32 arithmetic, a forward/inverse flag, one real scale applied
// once at the store; every twiddle from the host-f64 tables of w^k, and
// the radix-3 and radix-5 butterflies' constants as f32 literals of their
// f64 values (lane_dft.cuh).
//
// What bounds it on an H100: device-memory bandwidth (~3 flop/byte an
// axis); the form reads and writes the planes once. It keeps the frame of
// the power-of-two line form: a tile of 8 contiguous elements of L
// (kMidLanes; an f32 row is one 32-byte sector) split along n1 over a
// thread-block cluster of C <= 16 blocks, block b holding the rows k1 in
// [b n1 / C, (b + 1) n1 / C) (slabs), the ragged end of L masked, never
// padded. What is new are the lines: n = R P with R in {1, 3, 5, 7, 15}
// and P a power of two, n <= 240, and 256 (the lists below), each line
// in the registers of G = P / V lanes of one warp (MixLine):
// - lane l of a line holds x[l + G j + P s] for j < V, s < R: R V values,
//   V = line_values(P) halved while R V > 32 (at 160: 20 values on 8
//   lanes; at 56: 28 on 2; at 240: 30 on 8);
// - the odd factor first, in registers over stride P: for each j the
//   R-point DFT of lane_dft.cuh (dft3, dft5, 15 = 3 x 5 with its twiddles,
//   or prime_emit for 7), then x(p, q) times W_n^(p q) from the n-table
//   staged in shared memory (no device trig);
// - the R sub-lines of P on line_fft.cuh's __shfl_xor_sync exchange (G
//   <= V) or its radix-2 lane stages (G > V), with w_P^k = W_n^(R k) from
//   the same table (line_fft_staged): register (i, r) of place m ends
//   holding X[q_i + R Line<P, V>::out(m, r)].
// No line needs shared scratch. Each block:
//   1. stages the n1- and n2-tables, reads its rows of 8 L-elements into
//      the tile (MidTile; 16-byte loads where L % 4 == 0), the ragged end
//      of L as zeros;
//   2. __syncthreads; the n2 lines (slab, lane of L) from the tile into
//      registers, transformed, written back in place;
//   3. cluster.sync; each lane group reads its n1-column (flat (k2, l)) from
//      the cluster's tiles through map_shared_rank, transforms it and
//      stores it from registers, one element a value (a line's lanes of a
//      warp take consecutive columns: 8 lanes of L, one 32-byte f32 sector
//      a row, where W >= 8); each thread arrives on the cluster barrier
//      after its last remote read and waits on it before exit.
// At (160, 160) a block holds 12800 elements (100 KB) and runs 320
// threads in two rounds of its 640 lines' lanes, two blocks an SM. The
// storage dtype is an argument, not a template parameter: only the load
// and the store branch on it, so that a family's source compiles its 32
// n2 lines once (the build's time).
//
// Known costs (PERF.md; tools/mid_mixed_ab.py times copies of this header
// against it, tools/cluster_phases.py splits the steps): the form runs at
// 2.4-6x its bytes' bound. The load step and the n1 lines' stores (a row
// of a tile is 32 bytes, L elements apart) and the lines' DFTs at a few
// warps an SM take most of it; the exchange through distributed shared
// memory costs a few per cent. Lines of up to 48 values on the exchange
// alone (168 registers, blocks of 192) ran (160, 160) 15 % faster but
// (48, 160) 26 % slower, where the 96 registers of this form fit a third
// block an SM; a cap of 24 values ran (56, 56) 28 % slower (its 56-lines
// on 4 lanes of 14); design (b), whole lines in a lane with a scratch region
// for the n1 lines (tools/mid_fourstep_ab.cuh), a grid of the resident
// clusters looping over the tiles, 16 loads in flight a thread and
// another swizzle ran slower or the same.

#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "fft_stages.cuh"
#include "lane_dft.cuh"
#include "line_fft.cuh"

namespace tpufft_mid {

using namespace tpufft_fft;
using tpufft_lane::lane_dft;
using tpufft_lane::lane_dft_emit;
using tpufft_lane::lane_out;
using tpufft_lane::max_prime;
using tpufft_line::line_fft_staged;
using tpufft_line::line_values;

constexpr int kMidLanes = 8;       // elements of L a line-form tile takes
constexpr int kMidLoadUnroll = 8;
constexpr int kMidSlabPad = 8;     // float2 between slabs of the tile
constexpr int kMixThreads = 320;   // threads of a mixed-form block, at most
constexpr int kMixValues = 32;     // values a lane holds, at most

// The lengths of the generic-radix form, by the odd part of n (a CPU test,
// tests/test_torch_kernel_mid_pair.py, holds kernels/mid_pair_fft.py's
// MIXED_LENGTHS equal to them).
#define TPUFFT_MID_POW2(X) X(2) X(4) X(8) X(16) X(32) X(64) X(128) X(256)
#define TPUFFT_MID_R3(X) X(3) X(6) X(12) X(24) X(48) X(96) X(192)
#define TPUFFT_MID_R5(X) X(5) X(10) X(20) X(40) X(80) X(160)
#define TPUFFT_MID_R7(X) X(7) X(14) X(28) X(56) X(112) X(224)
#define TPUFFT_MID_R15(X) X(15) X(30) X(60) X(120) X(240)
#define TPUFFT_MID_LENGTHS(X) \
  TPUFFT_MID_POW2(X) TPUFFT_MID_R3(X) TPUFFT_MID_R5(X) TPUFFT_MID_R7(X) \
      TPUFFT_MID_R15(X)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The tile of a mid-pair line-form block: `slabs` slabs of n2 rows of
// kMidLanes elements. Two rows k2 make one 16-float2 bank row, in which
// the group of 4 float2 (index bits 3..2) is XORed with (k2 >> 1) & 3, and
// slabs lie n2 kMidLanes + 8 float2 apart. At (64, 128) every shared
// access is then free of bank conflicts but the 16-byte load's stores (2
// ways): the scalar load's half warps (two rows of 8), the n2 lines'
// reads (rows k2..k2 + 3, 4 lanes of L) and writes (rows k2, k2 + 2,
// k2 + 4, k2 + 6), and the n1 lines' 16-byte reads (two slabs, 8 lanes of
// L). Adjacent lanes of L (l even) stay adjacent, and groups of 4 whole.
// Any n2 takes it (an odd n2 leaves its last bank row half used).
struct MidTile {
  int slab;
  __host__ __device__ explicit MidTile(int n2)
      : slab(n2 * kMidLanes + kMidSlabPad) {}
  __device__ __forceinline__ int at(int j, int k2, int l) const {
    return j * slab + (k2 >> 1) * 16 +
           ((((k2 & 1) << 3) | l) ^ (((k2 >> 1) & 3) << 2));
  }
};

// Row r of a block's tile as (slab, k2) for n2 a power of two (shifts) ...
struct Pow2Rows {
  int shift, mask;
  __device__ __forceinline__ explicit Pow2Rows(int n2) {
    // set here, not in an initializer list: nvcc's host pass compiles a
    // constructor's initializer list, where __ffs is not declared
    shift = __ffs(n2) - 1;
    mask = n2 - 1;
  }
  __device__ __forceinline__ int slab(int r) const { return r >> shift; }
  __device__ __forceinline__ int k2(int r) const { return r & mask; }
};

// ... and for any n2 (a multiply-shift division).
struct AnyRows {
  Div by;
  int n2;
  __device__ __forceinline__ explicit AnyRows(int n) : by(n), n2(n) {}
  __device__ __forceinline__ int slab(int r) const { return by(r); }
  __device__ __forceinline__ int k2(int r) const { return r - by(r) * n2; }
};

// Step 1: the block's `rows` = slabs n2 rows of kMidLanes elements, the
// ragged end of L read as zeros, from device memory into the tile. A warp
// reads 4 rows of 8 consecutive elements a plane (f32: four full 32-byte
// sectors), kMidLoadUnroll loads in flight a thread.
template <typename T, typename Rows>
__device__ __forceinline__ void mid_line_load(const T* __restrict__ xr,
                                              const T* __restrict__ xi,
                                              float2* tile,
                                              const MidTile& at,
                                              int64_t row0, int64_t L,
                                              int64_t left, int rows,
                                              const Rows& split) {
  const int total = rows * kMidLanes;
  const int step = (int)blockDim.x;
  for (int e0 = (int)threadIdx.x; e0 < total; e0 += step * kMidLoadUnroll) {
    float2 v[kMidLoadUnroll];
#pragma unroll
    for (int u = 0; u < kMidLoadUnroll; ++u) {
      const int e = e0 + u * step, l = e % kMidLanes;
      v[u] = make_float2(0.f, 0.f);
      if (e < total && l < left) {
        const int64_t g = (row0 + e / kMidLanes) * L + l;
        v[u] = make_float2(load_f(xr, g), load_f(xi, g));
      }
    }
#pragma unroll
    for (int u = 0; u < kMidLoadUnroll; ++u) {
      const int e = e0 + u * step;
      if (e < total) {
        const int r = e / kMidLanes;
        tile[at.at(split.slab(r), split.k2(r), e % kMidLanes)] = v[u];
      }
    }
  }
}

// Four consecutive elements of a plane (16 bytes of f32, 8 of bf16; i a
// multiple of 4 and the plane aligned to that).
__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Step 1 where L % 4 == 0 and the planes take 4-element loads: each
// thread loads 4 consecutive lanes of a row from each plane (a whole
// 16-byte f32 chunk; the ragged end of L is then whole chunks) and writes
// them to the tile as two 16-byte stores (lanes l, l + 1 stay adjacent).
template <typename T, typename Rows>
__device__ __forceinline__ void mid_line_load4(const T* __restrict__ xr,
                                               const T* __restrict__ xi,
                                               float2* tile,
                                               const MidTile& at,
                                               int64_t row0, int64_t L,
                                               int64_t left, int rows,
                                               const Rows& split) {
  constexpr int kQuads = kMidLanes / 4;
  const int total = rows * kQuads;
  const int step = (int)blockDim.x;
  for (int e0 = (int)threadIdx.x; e0 < total;
       e0 += step * (kMidLoadUnroll / 2)) {
    float4 re[kMidLoadUnroll / 2], im[kMidLoadUnroll / 2];
#pragma unroll
    for (int u = 0; u < kMidLoadUnroll / 2; ++u) {
      const int e = e0 + u * step, l = e % kQuads * 4;
      re[u] = im[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total && l < left) {
        const int64_t g = (row0 + e / kQuads) * L + l;
        re[u] = load4(xr, g);
        im[u] = load4(xi, g);
      }
    }
#pragma unroll
    for (int u = 0; u < kMidLoadUnroll / 2; ++u) {
      const int e = e0 + u * step;
      if (e < total) {
        const int r = e / kQuads;
        float4* dst = reinterpret_cast<float4*>(
            tile + at.at(split.slab(r), split.k2(r), e % kQuads * 4));
        dst[0] = make_float4(re[u].x, im[u].x, re[u].y, im[u].y);
        dst[1] = make_float4(re[u].z, im[u].z, re[u].w, im[u].w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The generic-radix cluster line form (the header's notes)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int odd_part(int n) {
  while (n % 2 == 0) n /= 2;
  return n;
}

// Values of a P sub-line a lane holds next to R - 1 others: line_values(P),
// halved while the lane would hold more than kMixValues (the sub-line then
// spreads over G = P / V > V lanes: line_core's lane stages).
__host__ __device__ constexpr int mix_values(int R, int P) {
  int v = line_values(P);
  while (R * v > kMixValues && v > 1) v /= 2;
  return v;
}

// A line of N = R P on G lanes of a warp (the header's notes): place l
// holds input x[in(l, s, j)] in register (s, j) and ends holding output
// X[out(l, i, r)] in register (i, r); a warp holds W lines side by side,
// the lane of place l and slot c being l W + c.
template <int N>
struct MixLine {
  static constexpr int R = odd_part(N);
  static constexpr int P = N / R;
  static constexpr int V = P == 1 ? 1 : mix_values(R, P);
  static constexpr int G = P / V;
  static constexpr int W = 32 / G;
  static_assert(32 % G == 0, "a line's lanes in one warp");
  // the odd DFT's output in register i: lane_dft's order, or prime_emit's
  // natural one (R = 7)
  static __host__ __device__ constexpr int odd_out(int i) {
    return max_prime(R) >= 7 ? i : lane_out<R>(i);
  }
  static __device__ __forceinline__ int in(int l, int s, int j) {
    return l + G * j + P * s;
  }
  static __device__ __forceinline__ int out(int m, int i, int r) {
    if constexpr (P == 1)
      return odd_out(i);
    else
      return odd_out(i) + R * tpufft_line::Line<P, V>::out(m, r);
  }
};

// The DFT of one line held as MixLine<N> says; table: w^k, k < N, for the
// direction, staged at pad(k). Every lane of the warp calls it together.
template <int N>
__device__ __forceinline__ void mix_fft(
    float2 (&v)[MixLine<N>::R][MixLine<N>::V], int l, const float2* table,
    bool inv) {
  using ML = MixLine<N>;
  constexpr int R = ML::R, P = ML::P, V = ML::V;
  if constexpr (R > 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float2 t[R];
#pragma unroll
      for (int s = 0; s < R; ++s) t[s] = v[s][j];
      if constexpr (max_prime(R) >= 7) {
        lane_dft_emit<R, P, 0, 1>(t, table, inv,
                                  [&](int k, float2 w) { v[k][j] = w; });
      } else {
        lane_dft<R, P, 0, 1>(t, table, inv);
#pragma unroll
        for (int i = 0; i < R; ++i) v[i][j] = t[i];
      }
    }
    if constexpr (P > 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int q = ML::odd_out(i);
        if (q == 0) continue;
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[i][j] = cmul(v[i][j], table[pad((l + ML::G * j) * q)]);
      }
    }
  }
  if constexpr (P > 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) line_fft_staged<P, V, R>(v[i], l, table, inv);
  }
}

// Where a thread's task of round `it` lies: its place l and its line.
template <int N>
struct MixTask {
  int l, line;
  __device__ __forceinline__ explicit MixTask(int it) {
    constexpr int W = MixLine<N>::W;
    const int t = it * (int)blockDim.x + (int)threadIdx.x;
    l = (t & 31) / W;
    line = (t >> 5) * W + (t & 31) % W;
  }
};

// Lanes that `lines` lines of n take: whole warps of W lines (host and
// device).
__host__ __device__ inline int mix_lanes(int n, int lines) {
  const int R = odd_part(n), P = n / R;
  const int W = 32 / (P / (P == 1 ? 1 : mix_values(R, P)));
  return (lines + W - 1) / W * 32;
}

// Step 2: the n2 lines (slab j, lane l), `lines` = slabs kMidLanes of
// them, in place in the tile; consecutive lines are the lanes of L of one
// slab.
template <int N>
__device__ __forceinline__ void mix_n2(float2* tile, const MidTile& at,
                                       const float2* table, int lines,
                                       bool inv) {
  using ML = MixLine<N>;
  const int rounds = (mix_lanes(N, lines) + blockDim.x - 1) / blockDim.x;
  for (int it = 0; it < rounds; ++it) {
    const MixTask<N> tk(it);
    const bool valid = tk.line < lines;
    const int j = tk.line / kMidLanes, l = tk.line % kMidLanes;
    float2 v[ML::R][ML::V];
#pragma unroll
    for (int s = 0; s < ML::R; ++s)
#pragma unroll
      for (int q = 0; q < ML::V; ++q)
        v[s][q] = valid ? tile[at.at(j, ML::in(tk.l, s, q), l)]
                        : make_float2(0.f, 0.f);
    mix_fft<N>(v, tk.l, table, inv);
    if (valid) {
#pragma unroll
      for (int i = 0; i < ML::R; ++i)
#pragma unroll
        for (int r = 0; r < ML::V; ++r)
          tile[at.at(j, ML::out(tk.l, i, r), l)] = v[i][r];
    }
  }
}

// A line's outputs X[k1] to rows k1 of the planes: y[base + k1 stride],
// times the scale.
template <typename T, int N>
__device__ __forceinline__ void mix_store(
    void* yr_, void* yi_, const float2 (&v)[MixLine<N>::R][MixLine<N>::V],
    int m, int64_t base, int64_t stride, float scale) {
  using ML = MixLine<N>;
  T* yr = static_cast<T*>(yr_);
  T* yi = static_cast<T*>(yi_);
#pragma unroll
  for (int i = 0; i < ML::R; ++i)
#pragma unroll
    for (int r = 0; r < ML::V; ++r) {
      const int64_t g = base + (int64_t)ML::out(m, i, r) * stride;
      store_f(yr, g, v[i][r].x * scale);
      store_f(yi, g, v[i][r].y * scale);
    }
}

// Step 3: the block's `cols` n1-columns (flat (k2, l) positions [rank
// cols, rank cols + cols)), read from the cluster's tiles, transformed and
// stored from registers, the scale applied once; ends after the cluster
// barrier.
template <int N>
__device__ __forceinline__ void mix_n1(cooperative_groups::cluster_group& cluster,
                                       float2* tile, const MidTile& at,
                                       const float2* table, void* yr,
                                       void* yi, bool bf16, int64_t out0,
                                       int64_t L, int64_t left, int rank,
                                       int cols, int slabs, int n2,
                                       bool inv, float scale) {
  using ML = MixLine<N>;
  const Div by_slabs(slabs);
  const int rounds = (mix_lanes(N, cols) + blockDim.x - 1) / blockDim.x;
  for (int it = 0; it < rounds; ++it) {
    const MixTask<N> tk(it);
    const bool valid = tk.line < cols;
    const int col = rank * cols + tk.line;
    const int k2 = col / kMidLanes, l = col % kMidLanes;
    float2 v[ML::R][ML::V];
#pragma unroll
    for (int s = 0; s < ML::R; ++s)
#pragma unroll
      for (int q = 0; q < ML::V; ++q) {
        const int k1 = ML::in(tk.l, s, q);
        const int owner = by_slabs(k1);
        v[s][q] = valid ? cluster.map_shared_rank(tile, owner)[at.at(
                              k1 - owner * slabs, k2, l)]
                        : make_float2(0.f, 0.f);
      }
    if (it == rounds - 1) cluster_arrive();  // the last remote read is done
    mix_fft<N>(v, tk.l, table, inv);
    if (valid && l < left) {
      const int64_t base = out0 + (int64_t)k2 * L + l;
      if (bf16)
        mix_store<__nv_bfloat16, N>(yr, yi, v, tk.l, base, n2 * L, scale);
      else
        mix_store<float, N>(yr, yi, v, tk.l, base, n2 * L, scale);
    }
  }
  cluster_wait();
}

#define TPUFFT_MID_CASE(n)                  \
  case n:                                   \
    f(std::integral_constant<int, n>{});    \
    break;

// f(integral_constant<int, n>) for n on the form's lists ...
template <class F>
__device__ __forceinline__ void with_mix_length(int n, const F& f) {
  switch (n) { TPUFFT_MID_LENGTHS(TPUFFT_MID_CASE) }
}

// ... and for n in the family of odd part kFamily.
template <int kFamily, class F>
__device__ __forceinline__ void with_family(int n, const F& f) {
  if constexpr (kFamily == 1) {
    switch (n) { TPUFFT_MID_POW2(TPUFFT_MID_CASE) }
  } else if constexpr (kFamily == 3) {
    switch (n) { TPUFFT_MID_R3(TPUFFT_MID_CASE) }
  } else if constexpr (kFamily == 5) {
    switch (n) { TPUFFT_MID_R5(TPUFFT_MID_CASE) }
  } else if constexpr (kFamily == 7) {
    switch (n) { TPUFFT_MID_R7(TPUFFT_MID_CASE) }
  } else {
    switch (n) { TPUFFT_MID_R15(TPUFFT_MID_CASE) }
  }
}

#undef TPUFFT_MID_CASE

// Step 1 in storage T, with 4-element loads where `quads`.
template <typename T>
__device__ __forceinline__ void mix_load(const void* xr, const void* xi,
                                         bool quads, float2* tile,
                                         const MidTile& at, int64_t l0,
                                         int64_t row0, int64_t L,
                                         int64_t left, int rows,
                                         const AnyRows& split) {
  const T* ar = static_cast<const T*>(xr) + l0;
  const T* ai = static_cast<const T*>(xi) + l0;
  if (quads)
    mid_line_load4(ar, ai, tile, at, row0, L, left, rows, split);
  else
    mid_line_load(ar, ai, tile, at, row0, L, left, rows, split);
}

// K6, the generic-radix form, for n1 in the family of odd part kFamily
// (any n2 on the lists). Cluster c transforms tile c = (plane p, lanes
// [l0, l0 + kMidLanes)) of the (pre, n1, n2, L) planes; block `rank` holds
// rows k1 in [rank slabs, rank slabs + slabs) and, after the exchange, the
// n1-columns [rank cols, rank cols + cols) of flat (k2, l). Lanes at or
// past L load as zeros and are never stored. bf16: the storage dtype;
// quads: L % 4 == 0 and the input planes aligned for 4-element loads.
template <int kFamily>
__global__ void __launch_bounds__(kMixThreads, 2)
mid_mixed_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
                 void* __restrict__ yr, void* __restrict__ yi,
                 const float2* __restrict__ tw1,
                 const float2* __restrict__ tw2, int n1, int n2, int64_t L,
                 int csize, int bf16, int quads, int inverse, float scale) {
  extern __shared__ __align__(16) float2 tpufft_mixed_smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const MidTile at(n2);
  const int slabs = n1 / csize;
  float2* tile = tpufft_mixed_smem;
  float2* table1 = tile + slabs * at.slab;
  float2* table2 = table1 + pad(n1);
  for (int i = threadIdx.x; i < n1; i += blockDim.x)
    table1[pad(i)] = __ldg(&tw1[i]);
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    table2[pad(i)] = __ldg(&tw2[i]);
  const int cols = n2 * kMidLanes / csize;
  const int rank = (int)cluster.block_rank();
  const int64_t tile_id = blockIdx.x / csize;
  const int64_t ltiles = (L + kMidLanes - 1) / kMidLanes;
  const int64_t p = tile_id / ltiles;
  const int64_t l0 = (tile_id - p * ltiles) * kMidLanes;
  const int64_t left = L - l0;   // lanes of this tile inside L
  const bool inv = inverse != 0;
  const int64_t row0 = (p * n1 + (int64_t)rank * slabs) * n2;
  const AnyRows split(n2);
  if (bf16)
    mix_load<__nv_bfloat16>(xr, xi, quads != 0, tile, at, l0, row0, L, left,
                            slabs * n2, split);
  else
    mix_load<float>(xr, xi, quads != 0, tile, at, l0, row0, L, left,
                    slabs * n2, split);
  __syncthreads();
  with_mix_length(n2, [&](auto n) {
    mix_n2<decltype(n)::value>(tile, at, table2, slabs * kMidLanes, inv);
  });
  cluster.sync();
  with_family<kFamily>(n1, [&](auto n) {
    mix_n1<decltype(n)::value>(cluster, tile, at, table1, yr, yi, bf16 != 0,
                               p * n1 * n2 * L + l0, L, left, rank, cols,
                               slabs, n2, inv, scale);
  });
}

// ---------------------------------------------------------------------------
// Host: the form's lists, geometry and launch
// ---------------------------------------------------------------------------

// Is n on the form's lists?
inline bool mix_length(int n) {
#define TPUFFT_MID_IS(n) case n:
  switch (n) {
    TPUFFT_MID_LENGTHS(TPUFFT_MID_IS)
    return true;
    default:
      return false;
  }
#undef TPUFFT_MID_IS
}

// Does the pair take the generic-radix form: both axes on the lists but
// not both powers of two up to 128 (the power-of-two line form's pairs),
// tiles of kMidLanes lanes of L, a cluster of csize in {1, 2, 4, 8, 16}
// that divides n1 and the n2 kMidLanes columns, and a share of at most
// 16384 elements? kernels/mid_pair_fft.py:_geometry mirrors it.
inline bool mixed_pair(int n1, int n2, int lanes, int csize) {
  const auto pow2_128 = [](int n) { return n <= 128 && !(n & (n - 1)); };
  return mix_length(n1) && mix_length(n2) &&
         !(pow2_128(n1) && pow2_128(n2)) && lanes == kMidLanes &&
         (csize == 1 || csize == 2 || csize == 4 || csize == 8 ||
          csize == 16) &&
         n1 % csize == 0 && (n2 * kMidLanes) % csize == 0 &&
         (n1 / csize) * n2 * kMidLanes <= kMaxN;
}

struct MixShape {
  int threads;
  size_t smem;
};

// The block: the larger phase's lanes in the fewest rounds of at most
// kMixThreads threads, spread evenly over the rounds; the tile and the
// two staged tables.
inline MixShape mix_shape(int n1, int n2, int csize) {
  const int slabs = n1 / csize, cols = n2 * kMidLanes / csize;
  const int a = mix_lanes(n2, slabs * kMidLanes), b = mix_lanes(n1, cols);
  const int lanes = a > b ? a : b;
  const int rounds = (lanes + kMixThreads - 1) / kMixThreads;
  MixShape s;
  s.threads = ((lanes + rounds - 1) / rounds + 31) / 32 * 32;
  s.smem = (size_t)(slabs * MidTile(n2).slab + pad(n1) + pad(n2)) *
           sizeof(float2);
  return s;
}

// One launch's operands (cluster_fft.cu fills them).
struct MixArgs {
  const void *xr, *xi;
  void *yr, *yi;
  const void *tw1, *tw2;
  long long pre;
  int n1, n2;
  long long L;
  int csize, bf16, quads, inverse;
  float scale;
  cudaStream_t stream;
};

template <int kFamily>
int launch_mixed_as(const MixArgs& a) {
  auto* kernel = mid_mixed_kernel<kFamily>;
  const MixShape s = mix_shape(a.n1, a.n2, a.csize);
  const long long blocks =
      a.pre * ((a.L + kMidLanes - 1) / kMidLanes) * a.csize;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = cluster_config(kernel, s.threads, s.smem, blocks,
                                         a.csize, a.stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchKernelEx(&cfg, kernel, a.xr, a.xi, a.yr, a.yi,
                     static_cast<const float2*>(a.tw1),
                     static_cast<const float2*>(a.tw2), a.n1, a.n2,
                     (int64_t)a.L, a.csize, a.bf16, a.quads, a.inverse,
                     a.scale);
  return (int)cudaGetLastError();
}

// How many clusters of the form at (n1, n2, csize) the device holds at
// once.
template <int kFamily>
int mixed_clusters_as(int n1, int n2, int csize, int* out) {
  auto* kernel = mid_mixed_kernel<kFamily>;
  const MixShape s = mix_shape(n1, n2, csize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = cluster_config(kernel, s.threads, s.smem, csize,
                                         csize, 0, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// Each family's launcher and occupancy query (mid_line_<family>.cu).
#define TPUFFT_MID_FAMILY(name, family)                              \
  int launch_##name(const MixArgs& a) {                              \
    return launch_mixed_as<family>(a);                               \
  }                                                                  \
  int clusters_##name(int n1, int n2, int csize, int* out) {         \
    return mixed_clusters_as<family>(n1, n2, csize, out);            \
  }
int launch_mixed_pow2(const MixArgs& a);
int launch_mixed_r3(const MixArgs& a);
int launch_mixed_r5(const MixArgs& a);
int launch_mixed_r7(const MixArgs& a);
int launch_mixed_r15(const MixArgs& a);
int clusters_mixed_pow2(int n1, int n2, int csize, int* out);
int clusters_mixed_r3(int n1, int n2, int csize, int* out);
int clusters_mixed_r5(int n1, int n2, int csize, int* out);
int clusters_mixed_r7(int n1, int n2, int csize, int* out);
int clusters_mixed_r15(int n1, int n2, int csize, int* out);

// The launch, by n1's family (mixed_pair holds).
inline int launch_mixed(const MixArgs& a) {
  switch (odd_part(a.n1)) {
    case 1: return launch_mixed_pow2(a);
    case 3: return launch_mixed_r3(a);
    case 5: return launch_mixed_r5(a);
    case 7: return launch_mixed_r7(a);
  }
  return launch_mixed_r15(a);
}

inline int mixed_clusters(int n1, int n2, int csize, int* out) {
  switch (odd_part(n1)) {
    case 1: return clusters_mixed_pow2(n1, n2, csize, out);
    case 3: return clusters_mixed_r3(n1, n2, csize, out);
    case 5: return clusters_mixed_r5(n1, n2, csize, out);
    case 7: return clusters_mixed_r7(n1, n2, csize, out);
  }
  return clusters_mixed_r15(n1, n2, csize, out);
}

}  // namespace tpufft_mid
