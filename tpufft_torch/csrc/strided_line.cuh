// The line form of the strided-axis C2C FFT (K2, K3, K18, K19): device code,
// launch geometry and the launchers (strided_fft.cu picks the form and
// holds the stage form; strided_line_{pow2,r3,r5,r15,odd}.cu instantiate
// this header's kernels, one source per radix family so that nvcc builds
// them in parallel).
//
// Replaces the same four Pallas TPU kernels as the stage form
// (tpufft/kernels/mxu_fft.py: _build_inner, _build_inner_nd with with_tw,
// _build_inner_fused, _build_inner_fused_m1), with the same contract: the
// (pre, n, post) planes (post contiguous), or fused storage through
// kFused's load and store (fft_stages.cuh, fused_index, h = tw_l); f32 or
// bf16 storage, f32 arithmetic, a forward/inverse flag, the (n, tw_m)
// twiddle tw_nm at the store, one real scale applied once at the store;
// every twiddle from the host-f64 table of w^k, k < n, and the radix-3 and
// radix-5 butterflies' constants as f32 literals of their f64 values.
//
// What bounds it on an H100: device-memory bandwidth (~3 flop/byte), as for
// the minor axis; the n values of a transform lie post elements apart. The
// form carries the minor-axis line form (minor_fft.cuh, minor_lane_kernel)
// over to columns: lanes sit on consecutive columns c of the contiguous
// post axis, so every load and store goes straight between device memory
// and registers in runs of C columns (C = 8 f32 columns fill one 32-byte
// sector a row a plane), with no transposing load or store.
//
// The form covers n = r 2^a for r in {1, 3, 5} from 8 to 2048 and r = 15
// from 30 to 1920, and 25, 93 (3 x 31) and 1080 (line_split below), for a
// launch whose post is at least 8 columns in f32 (16 in bf16, a sector of
// bf16 values) and whose block stays within the launch bound (bf16 up to
// n = 1024). Longer lengths on the lists of strided_long.cuh (f32 from
// 2160, bf16 from 1080) run the cluster form there, whose unit tile is
// spread over a thread-block cluster; every other launch (a prime above
// 31, a length on no list) runs the stage form. A unit is C consecutive
// columns of one pre-slice (C a power
// of two from 8 to 32, line_geometry), every unit's columns past post
// compute on zeros and store nothing, and blocks loop over units on a grid
// of at most the blocks the card holds at once, so that each block stages
// the n-table in shared memory once.
// - n <= 32 (strided_lines_kernel): lane c of a unit loads its column's n
//   values (a warp instruction reads 32 / C rows of C columns), runs the
//   whole line in registers (lane_dft) and stores it: no tile, no barrier.
// - 40 <= n <= 2048 (strided_lane_kernel): the four-step n = N1 N2 by one
//   block of at least C n / 32 lanes, a team in K1's words. Pass 1: lane
//   (c, j2) loads x[N2 j1 + j2, c] for every j1 straight from device
//   memory (lanes on consecutive c first), runs the N1-long line in
//   registers, multiplies by w^(k1 j2) from the staged table and writes
//   each value once into the tile. One __syncthreads. Pass 2: lane (c, k1)
//   reads the N2 values (k1, .) of its column, runs the N2-long line (an
//   N2 of 36 to 64 on a lane pair, pair_dft), applies tw_nm and the scale
//   and stores X[k1 + N1 k2, c] straight to device memory. Lines whose
//   count is not a multiple of the lanes take extra rounds (at n = 93, 3 x
//   31: eleven rounds of 3-long lines in pass 1, one of 31-long ones in
//   pass 2). The tile holds (k1, j2) of column c at ((k1 N2 + (j2 ^ (k1 &
//   1))) C + c) for an even N2, ((k1 N2 + j2) C + c) for an odd one: half a
//   warp writes 16 consecutive lines of one k1 in pass 1 and reads one j2
//   of 16 consecutive lines in pass 2, which at C = 8 are two rows of 8
//   columns an odd number of rows apart, on opposite halves of the 16 bank
//   pairs (a CPU test, tests/test_torch_kernel_inner.py, checks every
//   geometry).
// The lines are the shared generic-radix DFT of lane_dft.cuh (radix 8, 4,
// 2, 3, 5 or an odd prime up to 31 first, the twiddles W_N^(a b) from the
// table, then the sub-lines; no exchange between lanes), so no radix costs
// a pass through shared memory; a line whose largest prime is 7 or more
// hands its outputs over as they are formed (lane_dft_emit; pass 2 into
// the line's own tile slots, then stored in order), which keeps a 31-long
// line at 62 floats of values: at 96 registers (lane_threads' bound) K2
// at 93 spills 72 bytes, against 1200-1900 when pass 2 stored straight
// from the sum (ptxas; PERF.md).
//
// The swapped store (kSwap, pass 1 of the two-pass split, always with kTw):
// the planes are (pre, n, post) with post = M L (tw_m = M, tw_l = L), and
// output (p, k, m L + l) goes to (p, m, k, l) of the (pre, M, n, L) order,
// so that pass 2 transforms m on the strided kernel and stores the natural
// order (out_at, out_step). Stored straight from registers, lanes on
// consecutive columns sit n L values apart. So where pass 2 runs in one
// round without emitting (R2 = 1: n = 480, 960, 1024, 1280, 1536, 1920,
// 2048) and L divides C, the lane kernel restages the unit: pass 2 writes
// its twiddled, scaled outputs into the tile as (c, k) rows, and the unit's
// C n outputs, one contiguous run of device memory, are stored by
// consecutive lanes (kRestage). Every other swapped launch stores straight.
// The lines kernel (n <= 32) has no swapped instantiation: strided_fft.cu
// sends a swapped launch there to the stage form.

#pragma once

#include <type_traits>
#include <utility>

#include "fft_stages.cuh"
#include "lane_dft.cuh"
#include "minor_fft.cuh"

namespace tpufft_strided {

using namespace tpufft_fft;
using namespace tpufft_lane;
using tpufft_minor::resident_grid;

constexpr int kLinesThreads = 128;   // a block of strided_lines_kernel
constexpr size_t kSmemMax = 232448;  // shared memory a block may take

// The launch bound of the lane kernel at n: two blocks of up to 320 lanes
// an SM, which holds a lane to 96 registers; where the narrowest unit (8
// f32 or 16 bf16 columns) takes more than 320 lanes (f32 n >= 1536, bf16
// n >= 768), one block of up to 512 lanes, at 128 registers. On the H100
// (tools/strided_phases.py, PERF.md) the 96-register bound runs K2 at n =
// 640 as two 320-lane blocks of C = 16 an SM, 0.220-0.225 ms against
// 0.238-0.257 for C = 8 at 128 registers, and n = 1024 at C = 8 11 %
// faster than at 128 registers, where 112 bytes spilled.
__host__ __device__ constexpr int lane_threads(int n, bool bf16) {
  return n * (bf16 ? 16 : 8) / 32 > 320 ? 512 : 320;
}
__host__ __device__ constexpr int lane_blocks(int n, bool bf16) {
  return lane_threads(n, bf16) == 320 ? 2 : 1;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Offset of column col in a row of the planes: the column itself, or in
// fused storage 2 col - col mod L (fused_index; the row stride is 2 post).
template <bool kFused>
__device__ __forceinline__ int64_t col_offset(int col, int L) {
  return kFused ? 2 * (int64_t)col - col % L : col;
}

// Slice p and first column of unit u: p = u / groups (a 32-bit division
// while the units fit).
__device__ __forceinline__ void unit_of(int64_t u, int64_t groups,
                                        int cols_log2, int64_t& p, int& c0) {
  if (u <= 0xffffffffll && groups <= 0xffffffffll) {
    const uint32_t q = (uint32_t)u / (uint32_t)groups;
    p = q;
    c0 = (int)((uint32_t)u - q * (uint32_t)groups) << cols_log2;
  } else {
    p = u / groups;
    c0 = (int)(u - p * groups) << cols_log2;
  }
}

// Slice p and first column of unit u, the slices of one column group
// first: the swapped store's order (kSwap), so that the units that read the
// same columns of the (n, M) twiddle run side by side and read it from
// device memory about once (at (4, 2^24) the table is 128 MB, more than
// the L2).
template <bool kColumnsFirst>
__device__ __forceinline__ void unit_at(int64_t u, int64_t pre,
                                        int64_t groups, int cols_log2,
                                        int64_t& p, int& c0) {
  if constexpr (kColumnsFirst) {
    const int64_t g = u / pre;
    p = u - g * pre;
    c0 = (int)g << cols_log2;
  } else {
    unit_of(u, groups, cols_log2, p, c0);
  }
}

// The table of w^k, k < n, into shared memory at pad(k).
__device__ __forceinline__ void stage_table(float2* table,
                                            const float2* __restrict__ tw,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    table[pad(i)] = __ldg(&tw[i]);
  __syncthreads();
}

// Output (row k, column col) of slice p: times tw_nm[k, col / tw_l] with
// kTw, times the scale, stored.
template <bool kTw, typename T>
__device__ __forceinline__ void store_out(T* __restrict__ yr,
                                          T* __restrict__ yi,
                                          const float2* __restrict__ tw_nm,
                                          int64_t g, int k, int tw_m, int cq,
                                          float2 w, float scale) {
  if constexpr (kTw) w = cmul(w, __ldg(&tw_nm[(int64_t)k * tw_m + cq]));
  store_f(yr, g, w.x * scale);
  store_f(yi, g, w.y * scale);
}

// Where output row k of column col of the n-long slab at row `slab` lies:
// (slab + k) S + col in the natural (pre, n, post) order (fused storage's
// column offset with kFused); with kSwap, in the (pre, M, n, L) order of
// post = M L, slab S + (col / L) n L + k L + col mod L. out_step is the
// step from row k to row k + 1.
template <bool kFused, bool kSwap>
__device__ __forceinline__ int64_t out_at(int64_t slab, int k, int64_t S,
                                          int col, int L, int n) {
  if constexpr (kSwap)
    return slab * S + (int64_t)(col / L) * n * L + (int64_t)k * L + col % L;
  else
    return (slab + k) * S + col_offset<kFused>(col, L);
}
template <bool kSwap>
__device__ __forceinline__ int64_t out_step(int64_t S, int L) {
  return kSwap ? (int64_t)L : S;
}

// The restaged unit's (c, k) row position in the tile: c n + (k ^ s(c)),
// s(c) the 4-bit reversal of c mod 16 (n is a multiple of 16). A half warp
// of pass 2's writes (16 consecutive c of one row k, or 8 of rows k and
// k + 1 at C = 8) meets 16 bank pairs, and so does one of the stores'
// reads (L consecutive c, whose s(c) differ in the high bits, by 16 / L
// consecutive k, which differ in the low ones).
__device__ __forceinline__ int restage_pos(int c, int k, int n) {
  return c * n + (k ^ (int)(__brev((unsigned)c) >> 28));
}

// Arguments shared by both kernels (the stage form's, less the plan): the
// (pre, n, post) planes, the n-table tw, tw_nm ((n, tw_m) with tw_m tw_l =
// post, read with kTw only: a runtime test of it at every store cost the
// kernels their registers, 72-89 against 128 with spills at n = 64 to
// 256, and 7 % of their time at n = 128 and 1024 (tools/strided_phases.py
// on the H100); null for kFused, where tw_l = L is the half), and C =
// 2^cols_log2 columns a unit.
#define TPUFFT_LINE_PARAMS                                                  \
  const T *__restrict__ xr, const T *__restrict__ xi, T *__restrict__ yr,  \
      T *__restrict__ yi, const float2 *__restrict__ tw,                    \
      const float2 *__restrict__ tw_nm, int64_t pre, int post, int tw_m,    \
      int tw_l, int cols_log2, int inverse, float scale

// n <= 32: one column line a lane. A block of kLinesThreads lanes takes
// kLinesThreads / C units at a time, lane t column t mod C of unit t / C.
template <typename T, int N, bool kFused, bool kTw>
__global__ void __launch_bounds__(kLinesThreads)
strided_lines_kernel(TPUFFT_LINE_PARAMS) {
  extern __shared__ float2 tpufft_strided_line_smem[];
  float2* table = tpufft_strided_line_smem;
  stage_table(table, tw, N);
  const int C = 1 << cols_log2, c = threadIdx.x & (C - 1);
  const int per = kLinesThreads >> cols_log2;
  const int64_t S = kFused ? 2 * (int64_t)post : post;
  const int64_t groups = (post + C - 1) >> cols_log2;
  const int64_t units = pre * groups;
  const bool inv = inverse != 0;
  for (int64_t u = (int64_t)blockIdx.x * per + (threadIdx.x >> cols_log2);
       u < units; u += (int64_t)gridDim.x * per) {
    int64_t p;
    int c0;
    unit_of(u, groups, cols_log2, p, c0);
    const int col = c0 + c;
    if (col >= post) continue;
    const int64_t g0 = p * N * S + col_offset<kFused>(col, tw_l);
    float2 v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t g = g0 + j * S;
      v[j] = make_float2(load_f(xr, g), load_f(xi, g));
    }
    if constexpr (max_prime(N) >= 7) {
      // the outputs in order, as lane_dft's registers (y holds them as the
      // sum forms them; only lengths of the form with a prime from 7 come
      // here)
      float2 y[N];
      lane_dft_emit<N, 1, 0, 1>(v, table, inv,
                                [&](int k, float2 w) { y[k] = w; });
      const int cq = kTw ? col / tw_l : 0;
#pragma unroll
      for (int k = 0; k < N; ++k)
        store_out<kTw>(yr, yi, tw_nm, g0 + k * S, k, tw_m, cq, y[k], scale);
    } else {
      lane_dft<N, 1, 0, 1>(v, table, inv);
      const int cq = kTw ? col / tw_l : 0;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int k = lane_out<N>(q);
        store_out<kTw>(yr, yi, tw_nm, g0 + k * S, k, tw_m, cq, v[q], scale);
      }
    }
  }
}

// The tile position of (k1, j2) of column c (the header's layout): for an
// even N2 the XOR puts the rows k1 and k1 + 1 of one j2 an odd number of
// rows apart; an odd N2 does that by itself.
template <int N2>
__device__ __forceinline__ int tile_pos(int c, int k1, int j2,
                                        int cols_log2) {
  if constexpr (N2 % 2 == 0)
    return ((k1 * N2 + (j2 ^ (k1 & 1))) << cols_log2) + c;
  else
    return ((k1 * N2 + j2) << cols_log2) + c;
}

// 40 <= n <= 2048: the four-step by one block of at least C n / 32 lanes
// (a whole number of warps). Pass 1's lines (c, j2) are t + blockDim s
// (c = line mod C, j2 = line / C), pass 2's (c, k1) alike, or for N2 of 34
// to 64 (t mod 16) + 16 (t / 32) + blockDim / 2 s on the pair t, t ^ 16.
// The rounds s stay rolled, so that no round's values are live in the
// next (with them unrolled, K2's (32, 20) spilled 16 bytes at 96
// registers). A line whose largest prime is 7 or more hands its outputs
// over as it forms them (lane_dft_emit), so that a 31-long line holds 62
// floats: pass 1 into the tile, pass 2 into the line's own tile slots,
// stored from there in order.
// With kSwap (only with kTw) the outputs go to the (pre, M, n, L) order
// (the header's notes): restaged through the tile where kRestage and L
// divides C, else stored straight.
template <typename T, int N1, int N2, bool kFused, bool kTw, bool kSwap>
__global__ void __launch_bounds__(
    lane_threads(N1 * N2, std::is_same<T, __nv_bfloat16>::value),
    lane_blocks(N1 * N2, std::is_same<T, __nv_bfloat16>::value))
strided_lane_kernel(TPUFFT_LINE_PARAMS) {
  constexpr int n = N1 * N2;
  constexpr bool kPair = N2 > 32;
  static_assert(N1 <= 32 && (!kPair || (N2 % 4 == 0 && N2 <= 64)),
                "a line of up to 32 in a lane, 34 to 64 on a pair");
  static_assert(!kSwap || (kTw && !kFused), "the swap is the two-pass's");
  // rounds, with blockDim >= C n / 32 (C n / 64 pairs)
  constexpr int R1 = (32 + N1 - 1) / N1;
  constexpr int R2 = kPair ? (64 + N2 - 1) / N2 : (32 + N2 - 1) / N2;
  constexpr bool kRestage =
      kSwap && R2 == 1 && max_prime(N2) < 7 && n % 16 == 0;
  extern __shared__ float2 tpufft_strided_line_smem[];
  float2* table = tpufft_strided_line_smem;
  float2* tile = table + pad(n);
  stage_table(table, tw, n);
  const int C = 1 << cols_log2, lanes = blockDim.x;
  const int64_t S = kFused ? 2 * (int64_t)post : post;
  const int64_t groups = (post + C - 1) >> cols_log2;
  const int64_t units = pre * groups;
  const bool inv = inverse != 0;
  const int p2 = (threadIdx.x >> 4) & 1;  // place in a lane pair
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    int64_t p;
    int c0;
    unit_at<kSwap>(u, pre, groups, cols_log2, p, c0);
    const int64_t slab = p * n;
#pragma unroll 1
    for (int s = 0; s < R1; ++s) {  // pass 1: device memory -> tile
      const int line = threadIdx.x + lanes * s;
      if (line < (N2 << cols_log2)) {
        const int c = line & (C - 1), j2 = line >> cols_log2;
        const int col = c0 + c;
        float2 v[N1];
        if (col < post) {
          const int64_t g0 =
              (slab + j2) * S + col_offset<kFused>(col, tw_l);
#pragma unroll
          for (int j1 = 0; j1 < N1; ++j1) {
            const int64_t g = g0 + (int64_t)(N2 * j1) * S;
            v[j1] = make_float2(load_f(xr, g), load_f(xi, g));
          }
        } else {
#pragma unroll
          for (int j1 = 0; j1 < N1; ++j1) v[j1] = make_float2(0.f, 0.f);
        }
        auto put = [&](int k1, float2 w) {
          tile[tile_pos<N2>(c, k1, j2, cols_log2)] =
              cmul(w, table[pad(k1 * j2)]);
        };
        if constexpr (max_prime(N1) >= 7) {
          lane_dft_emit<N1, N2, 0, 1>(v, table, inv, put);
        } else {
          lane_dft<N1, N2, 0, 1>(v, table, inv);
#pragma unroll
          for (int q = 0; q < N1; ++q) put(lane_out<N1>(q), v[q]);
        }
      }
    }
    __syncthreads();
    const bool restage = kRestage && (C % tw_l) == 0;
    if (restage) {  // pass 2 into (c, k) rows of the tile, then stores
      if constexpr (kRestage) {
        constexpr int V = kPair ? N2 / 2 : N2;
        float2 v[V];
        const int line = kPair ? (threadIdx.x & 15) + 16 * (threadIdx.x >> 5)
                               : threadIdx.x;
        const bool valid = line < (N1 << cols_log2);
        const int c = line & (C - 1), k1 = line >> cols_log2;
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[i] = valid ? tile[tile_pos<N2>(c, k1, kPair ? p2 + 2 * i : i,
                                           cols_log2)]
                       : make_float2(0.f, 0.f);
        __syncthreads();  // every line of the tile is read
        const int col = c0 + c;
        const int cq = col / tw_l;
        auto put = [&](int k, float2 w) {
          if (valid && col < post) {
            w = cmul(w, __ldg(&tw_nm[(int64_t)k * tw_m + cq]));
            tile[restage_pos(c, k, n)] =
                make_float2(w.x * scale, w.y * scale);
          }
        };
        if constexpr (kPair) {
          pair_dft<V, N1>(v, p2, table, inv);
#pragma unroll
          for (int r = 0; r < V; ++r) put(k1 + N1 * pair_out<V>(p2, r), v[r]);
        } else if (valid) {
          lane_dft<N2, N1, 0, 1>(v, table, inv);
#pragma unroll
          for (int q = 0; q < N2; ++q) put(k1 + N1 * lane_out<N2>(q), v[q]);
        }
        __syncthreads();
        // output e of the unit is (column c0 + (e / (n L)) L + e mod L, row
        // e / L mod n): device memory slab S + c0 n + e
        const int ll = __ffs(tw_l) - 1;
        const int64_t base = slab * S + (int64_t)c0 * n;
        for (int e = threadIdx.x; e < (n << cols_log2); e += lanes) {
          const int r = e >> ll, mm = r / n, k = r - mm * n;
          const int cc = (mm << ll) + (e & (tw_l - 1));
          if (c0 + cc < post) {
            const float2 w = tile[restage_pos(cc, k, n)];
            store_f(yr, base + e, w.x);
            store_f(yi, base + e, w.y);
          }
        }
      }
    } else if constexpr (kPair) {  // pass 2 on lane pairs: tile -> memory
      constexpr int H = N2 / 2;
#pragma unroll 1
      for (int round = 0; round < R2; ++round) {
        const int line = (threadIdx.x & 15) + 16 * (threadIdx.x >> 5) +
                         (lanes >> 1) * round;
        const bool valid = line < (N1 << cols_log2);
        const int c = line & (C - 1), k1 = line >> cols_log2;
        float2 v[H];
#pragma unroll
        for (int i = 0; i < H; ++i)
          v[i] = valid ? tile[tile_pos<N2>(c, k1, p2 + 2 * i, cols_log2)]
                       : make_float2(0.f, 0.f);
        pair_dft<H, N1>(v, p2, table, inv);
        const int col = c0 + c;
        if (valid && col < post) {
          const int64_t g0 =
              out_at<kFused, kSwap>(slab, k1, S, col, tw_l, n);
          const int64_t ks = out_step<kSwap>(S, tw_l);
          const int cq = kTw ? col / tw_l : 0;
#pragma unroll
          for (int r = 0; r < H; ++r) {
            const int k = k1 + N1 * pair_out<H>(p2, r);
            store_out<kTw>(yr, yi, tw_nm, g0 + (int64_t)(k - k1) * ks, k,
                           tw_m, cq, v[r], scale);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < R2; ++s) {  // pass 2: tile -> device memory
        const int line = threadIdx.x + lanes * s;
        if (line < (N1 << cols_log2)) {
          const int c = line & (C - 1), k1 = line >> cols_log2;
          float2 v[N2];
#pragma unroll
          for (int j = 0; j < N2; ++j)
            v[j] = tile[tile_pos<N2>(c, k1, j, cols_log2)];
          const int col = c0 + c;
          if constexpr (max_prime(N2) >= 7) {
            // the outputs go back to the line's own tile slots as they are
            // formed (no other lane reads them), then out in order: stores
            // straight from the emitting sum kept 31 64-bit addresses live
            // beside the line's 62 floats (1200-1900 bytes spilled)
            lane_dft_emit<N2, N1, 0, 1>(v, table, inv, [&](int k2, float2 w) {
              tile[tile_pos<N2>(c, k1, k2, cols_log2)] = w;
            });
            if (col < post) {
              const int64_t g0 =
                  out_at<kFused, kSwap>(slab, k1, S, col, tw_l, n);
              const int64_t ks = out_step<kSwap>(S, tw_l);
              const int cq = kTw ? col / tw_l : 0;
#pragma unroll
              for (int k2 = 0; k2 < N2; ++k2)
                store_out<kTw>(yr, yi, tw_nm, g0 + (int64_t)(N1 * k2) * ks,
                               k1 + N1 * k2, tw_m, cq,
                               tile[tile_pos<N2>(c, k1, k2, cols_log2)],
                               scale);
            }
          } else {
            lane_dft<N2, N1, 0, 1>(v, table, inv);
            if (col < post) {
              const int64_t g0 =
                  out_at<kFused, kSwap>(slab, k1, S, col, tw_l, n);
              const int64_t ks = out_step<kSwap>(S, tw_l);
              const int cq = kTw ? col / tw_l : 0;
#pragma unroll
              for (int q = 0; q < N2; ++q) {
                const int k2 = lane_out<N2>(q);
                store_out<kTw>(yr, yi, tw_nm, g0 + (int64_t)(N1 * k2) * ks,
                               k1 + N1 * k2, tw_m, cq, v[q], scale);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is read before it is rewritten
  }
}

#undef TPUFFT_LINE_PARAMS

// ---------------------------------------------------------------------------
// Host: geometry and launch
// ---------------------------------------------------------------------------

// The four-step n = N1 N2 of each length of the form (lines of at most 32
// in a lane, an even N2 of 34 to 64 on a lane pair); N2 = 1 for n <= 32,
// one line a lane. The lengths are r 2^a for r in {1, 3, 5} from 8 to
// 2048 and 15 2^a from 30 to 1920, and 25, 93 and 1080. False outside the
// form.
inline bool line_split(int n, int* n1, int* n2) {
  static const int kSplits[][3] = {
      {8, 8, 1},       {10, 10, 1},     {12, 12, 1},     {16, 16, 1},
      {20, 20, 1},     {24, 24, 1},     {25, 25, 1},     {30, 30, 1},
      {32, 32, 1},     {40, 10, 4},     {48, 12, 4},     {60, 15, 4},
      {64, 8, 8},      {80, 10, 8},     {93, 3, 31},     {96, 12, 8},
      {120, 15, 8},    {128, 16, 8},    {160, 20, 8},    {192, 24, 8},
      {240, 15, 16},   {256, 16, 16},   {320, 20, 16},   {384, 24, 16},
      {480, 15, 32},   {512, 32, 16},   {640, 32, 20},   {768, 32, 24},
      {960, 15, 64},   {1024, 32, 32},  {1080, 30, 36},  {1280, 20, 64},
      {1536, 24, 64},  {1920, 30, 64},  {2048, 32, 64}};
  for (const auto& s : kSplits)
    if (s[0] == n) {
      *n1 = s[1];
      *n2 = s[2];
      return true;
    }
  return false;
}

struct LineGeometry {
  int n1, n2;     // the split (n2 = 1: strided_lines_kernel)
  int cols_log2;  // C = 2^cols_log2 columns a unit
  int threads;    // a block
  size_t smem;    // bytes: the padded n-table and the tile of C n values
};

// The line form's geometry for n and post in f32 or bf16 storage: C, the
// columns a unit, is the widest of 32, 16 and 8 whose team stays within the
// launch bound (lane_threads) and whose columns within post. False (the
// stage form) outside the form: n not in line_split, post under 8 columns
// (16 in bf16), or a block past the launch bound or the shared memory.
inline bool line_geometry(int n, long long post, bool bf16,
                          LineGeometry* g) {
  if (!line_split(n, &g->n1, &g->n2)) return false;
  const int min_cols = bf16 ? 16 : 8;
  if (post < min_cols) return false;
  int cols = 32;
  while (cols > min_cols &&
         (cols > post || (g->n2 > 1 && cols * n / 32 > lane_threads(n, bf16))))
    cols /= 2;
  g->cols_log2 = cols == 8 ? 3 : cols == 16 ? 4 : 5;
  g->threads = g->n2 == 1 ? kLinesThreads
                          : ((cols * n + 31) / 32 + 31) / 32 * 32;
  g->smem = (size_t)(pad(n) + (g->n2 == 1 ? 0 : cols * n)) * sizeof(float2);
  return g->threads <= lane_threads(n, bf16) && g->smem <= kSmemMax;
}

// One launch's operands (strided_fft.cu fills it).
struct LineArgs {
  const void *xr, *xi;
  void *yr, *yi;
  const void *tw, *tw_nm;
  long long pre, post;
  int tw_m;
  long long tw_l;
  int inverse;
  float scale;
  cudaStream_t stream;
  int swap = 0;  // the swapped store (kSwap; with tw_nm only)
};

template <typename T, int N, bool kFused, bool kTw>
int launch_lines_as(const LineArgs& a, const LineGeometry& g) {
  auto* kernel = strided_lines_kernel<T, N, kFused, kTw>;
  if (g.n1 != N || g.n2 != 1) return (int)cudaErrorInvalidValue;
  const long long groups = (a.post + (1 << g.cols_log2) - 1) >> g.cols_log2;
  const long long per = kLinesThreads >> g.cols_log2;
  unsigned blocks = 0;
  const cudaError_t err = resident_grid(
      kernel, g.threads, g.smem, (a.pre * groups + per - 1) / per, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, g.threads, g.smem, a.stream>>>(
      static_cast<const T*>(a.xr), static_cast<const T*>(a.xi),
      static_cast<T*>(a.yr), static_cast<T*>(a.yi),
      static_cast<const float2*>(a.tw), static_cast<const float2*>(a.tw_nm),
      (int64_t)a.pre, (int)a.post, a.tw_m, (int)a.tw_l, g.cols_log2,
      a.inverse, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int N1, int N2, bool kFused, bool kTw, bool kSwap>
int launch_lane_as(const LineArgs& a, const LineGeometry& g) {
  auto* kernel = strided_lane_kernel<T, N1, N2, kFused, kTw, kSwap>;
  if (g.n1 != N1 || g.n2 != N2) return (int)cudaErrorInvalidValue;
  const long long groups = (a.post + (1 << g.cols_log2) - 1) >> g.cols_log2;
  unsigned blocks = 0;
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, g.threads, g.smem, a.pre * groups, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, g.threads, g.smem, a.stream>>>(
      static_cast<const T*>(a.xr), static_cast<const T*>(a.xi),
      static_cast<T*>(a.yr), static_cast<T*>(a.yi),
      static_cast<const float2*>(a.tw), static_cast<const float2*>(a.tw_nm),
      (int64_t)a.pre, (int)a.post, a.tw_m, (int)a.tw_l, g.cols_log2,
      a.inverse, a.scale);
  return (int)cudaGetLastError();
}

// The kernel with the twiddle at the store where tw_nm is set (never on
// fused storage), with the swapped store where swap is set too, else
// without (the lines kernel has no swapped store: launch_sized keeps a
// swapped launch away from it).
template <typename T, int N, bool kFused>
int launch_lines(const LineArgs& a, const LineGeometry& g) {
  if (a.swap) return (int)cudaErrorInvalidValue;
  if constexpr (!kFused)
    if (a.tw_nm != nullptr) return launch_lines_as<T, N, kFused, true>(a, g);
  return launch_lines_as<T, N, kFused, false>(a, g);
}

template <typename T, int N1, int N2, bool kFused>
int launch_lane(const LineArgs& a, const LineGeometry& g) {
  if constexpr (!kFused)
    if (a.tw_nm != nullptr)
      return a.swap ? launch_lane_as<T, N1, N2, kFused, true, true>(a, g)
                    : launch_lane_as<T, N1, N2, kFused, true, false>(a, g);
  return launch_lane_as<T, N1, N2, kFused, false, false>(a, g);
}

// The launchers of each radix family (strided_line_{pow2,r3,r5,r15,odd}.cu):
// the length's kernel in storage T, or cudaErrorInvalidValue for a length
// the family does not hold.
template <typename T, bool kFused>
int launch_line_pow2(const LineArgs& a, const LineGeometry& g);
template <typename T, bool kFused>
int launch_line_r3(const LineArgs& a, const LineGeometry& g);
template <typename T, bool kFused>
int launch_line_r5(const LineArgs& a, const LineGeometry& g);
template <typename T, bool kFused>
int launch_line_r15(const LineArgs& a, const LineGeometry& g);
template <typename T, bool kFused>
int launch_line_odd(const LineArgs& a, const LineGeometry& g);

// n's family: n = r 2^a for r = 15, 3, 5 or 1; 25, 93 and 1080 the odd one.
inline int line_family(int n) {
  int m = n;
  while (m % 2 == 0) m /= 2;
  return m == 1 || m == 3 || m == 5 || m == 15 ? m : 0;
}

template <typename T, bool kFused>
int launch_line(const LineArgs& a, const LineGeometry& g) {
  switch (line_family(g.n1 * g.n2)) {
    case 1: return launch_line_pow2<T, kFused>(a, g);
    case 3: return launch_line_r3<T, kFused>(a, g);
    case 5: return launch_line_r5<T, kFused>(a, g);
    case 15: return launch_line_r15<T, kFused>(a, g);
  }
  return launch_line_odd<T, kFused>(a, g);
}

}  // namespace tpufft_strided
