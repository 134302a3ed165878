// Device code of the batched minor-axis C2C FFT (see minor_fft.cu).
//
// Replaces tpufft/kernels/mxu_fft.py:_build_minor (the Pallas TPU kernel
// behind every contiguous minor-axis transform). Contract, as there:
// (batch, n) split re/im planes stored in f32 or bf16 -> the (batch, n)
// DFT in natural order, in the same storage dtype; f32 arithmetic; a
// forward/inverse flag; one real scale applied once, at the store. Every
// twiddle comes from the host-f64 table of w^k, k < n - no device trig.
// Both forms on fused storage (kFused) replace _build_minor_fused (K20),
// whose block-complex matmul st @ [[Wr, Wi], [-Wi, Wr]] is this DFT of each
// row's two halves: only the load and the store differ.
//
// What bounds it on an H100: device-memory bandwidth. A pass reads and
// writes each complex element once (16 bytes in f32) against ~5 log2(n)
// flops, about 3 flop/byte at n = 1024, far below the card's
// compute/bandwidth ratio. The design therefore touches device memory
// exactly once each way, with coalesced loads and stores in natural order.
// The TPU kernel's dense DFT matmuls and batch-on-lanes transposes exist
// for the MXU and are not carried over.
//
// The kernel has two forms; the host picks one by n (minor_fft.cu,
// launch_sized; kernels/minor_fft.py:form mirrors the choice).
//
// The line form, for power-of-two n from 2 to 4096, the mixed-radix
// lengths of the family lists below (3, 5 and 15 times a power of two up
// to 3072, 2560 and 3840; 93, 1000, 1080, 2160) and the three-factor
// lengths from 4096 (TPUFFT_MINOR_LONG: 4096, 4320, 5120, 6144, 7680,
// 8192, 8320, 10240, 12288, 15360, 16384) (K1, K20, and K9 at any n_in <
// n):
// each row crosses device memory once each way, lives in registers, and
// goes through shared memory at most once each way (twice in the
// three-factor form). Every line DFT is the shared generic-radix one of
// lane_dft.cuh (radices 2, 4, 8, 3, 5 and odd primes 7 to 31 in one lane's
// registers, no exchange between lanes but the pair's).
// - power-of-two n <= 64 (minor_lines_kernel): a row is one line of
//   line_fft.cuh, on n/8 lanes of a warp that swap values by
//   __shfl_xor_sync. Lane (l, c) loads x[l + G j] of row c straight from
//   device memory (8 consecutive elements of 4 rows a warp instruction at
//   n = 64) and stores X[out(l, r)] the same way: no shared memory, no
//   barrier.
// - every other length of the form (minor_lane_kernel, LaneStep): the
//   four-step n = N1 N2 (each at most 64; line_split in the wrapper) by a
//   team of one to four warps. Pass 1 transforms the N1-long column lines
//   j2 of the (N1, N2) view of a row, each whole in the registers of one
//   lane (lane_dft; a line of 34 to 64 lies on a lane pair, pair_dft,
//   which swaps half its values once), consecutive lanes on consecutive
//   columns, so that a warp's load instruction reads consecutive elements
//   of a row (one 128-byte line in f32 at n = 1024). Each value Y[k1, j2]
//   is multiplied by w^(k1 j2), read at index k1 j2 of the table staged
//   once a block in shared memory, and written once into the team's tile.
//   One team barrier (__syncwarp, or a named barrier for several warps);
//   pass 2 reads the N2-long lines k1 back, consecutive lanes on
//   consecutive k1, and stores X[k1 + N1 k2] from registers. A line whose
//   largest prime is 7 or more (93 = 31 x 3) hands its outputs to the tile
//   or the store as its conjugate-pair sum forms them (lane_dft_emit).
//   At powers of two a team holds R = 1024 W / n rows, 32 values a lane,
//   and the tile holds (k1, j2) of row r at r n + k1 N2 + (j2 ^ ((k1 + N1
//   r) mod 16)); at 1024 a team is one warp, a block four teams (128
//   threads, ~41 KB of shared memory, at most 102 registers: five blocks
//   an SM). At a mixed-radix n no such packing exists (no power of two
//   rows fill the lanes, the XOR can leave a row that is not a multiple
//   of 16): LaneStep takes R rows a team, lanes take line slots r Q + j
//   in rounds (Q >= the lines a row; the slots past them idle), every
//   round's values held at once (20 to 36 a lane), and the tile holds (k1,
//   j2) of row r at r RS + k1 P2 + j2 with Q1, Q2, P2 and RS chosen (the
//   family lists) so that every half warp of both passes touches 16
//   distinct bank pairs; blocks of 128 threads, four an SM (128
//   registers), three (168) where a line lies on a lane pair. At 93 (31 x
//   3; 3 x 31, whose stores would run 3 elements long, took 3x the time)
//   pass 1 loads runs of 3 elements of ~11 rows a warp instruction (the
//   bytes of a team's 10 rows are one contiguous run, read once), pass 2
//   stores runs of 31. Blocks loop over row
//   groups, so that the table is staged once per resident block, and after
//   the staging no block-wide barrier runs: the warps of an SM overlap one
//   team's loads with another's line DFTs. The wrapper's line_geometry
//   mirrors every geometry for a CPU test of the tile.
//   Every load and store is a 4-byte (2-byte in bf16) access, so a view
//   that does not start on a 16-byte boundary, and a row of odd length,
//   run it too.
// - K9 (kPadded: minor_lines_padded_kernel, minor_lane_padded_kernel) is
//   the same kernel with the pad in its load (row_load): element col of
//   row r is read at r n_in + col, and only where col < n_in; above that
//   the register is 0 and no memory request is issued. In pass 1 of the
//   lane kernel, lane j2's register j1 holds x[N2 j1 + j2], so it is 0
//   for j1 >= ceil((n_in - j2) / N2). The butterflies still run on the
//   zeros (the pass is bound by bytes, n_in is known only at run time).
//   The store is K1's. At odd n_in (93) a row starts at any 4-byte
//   offset, and a half warp's 16 consecutive loads touch up to 3 sectors
//   instead of 2.
// - the three-factor lengths (minor_long_kernel, LongStep; 4096, where it
//   beat the 64 x 64 four-step on lane pairs, and the lengths above):
//   n = N1 N2 N3, each factor at most 32 and whole in one lane, by a
//   block of 256 threads (512 at 15360 and 16384) that holds one row at a
//   time in its tile (up to 128 KB): pass 1 loads the N1-long columns
//   straight from device memory (consecutive lanes on consecutive
//   elements), twiddles them by w^(k1 u) and writes the tile; pass 2
//   transforms the N2-long lines in the tile in place and twiddles them
//   by w_(N2 N3)^(k2 j3); pass 3 stores the N3-long lines from registers
//   to X[k1 + N1 (k2 + N2 k3)], consecutive lanes on consecutive outputs.
//   Three block barriers a row, against two a Stockham stage. The full
//   n-table would not fit beside a 16384 row's tile, so the twiddles are
//   three small tables staged once a block (LongStep: pass 1's w^(k1 u)
//   is the product of two of them), indexed so that no half warp meets a
//   bank conflict; the padded tile (P1, P2) has none either. Blocks loop
//   over rows; two share an SM (128 registers) up to 12288, one above.
//
// The stage form (minor_fft_kernel), for every other length (K1, K20 and
// K9 alike, e.g. 127 or any prime above 31, n in (4096, 16384] outside
// TPUFFT_MINOR_LONG such as 4100; stages=True runs it at every length): a
// block loads whole rows into shared memory, runs every Stockham stage
// there (fft_stages.cuh, shared with the strided-axis and pair kernels),
// and stores the rows. Two details keep it near the bandwidth bound:
// - the load and the store are unrolled over a thread's kPer values, so
//   each thread has 2 kPer device-memory requests in flight;
// - rows of n <= 4096 are packed ~4096 elements to a block of up to 512
//   threads with kPer = 8, and __launch_bounds__(512, 2) holds registers
//   to 64 so that two such blocks share an SM (a block that keeps more
//   registers than that runs alone on its SM, with nothing to overlap its
//   load with; longer rows take one block of n/16 threads with kPer = 16).
// Each stage synchronizes the block twice: at n = 1024, 9 block-wide
// barriers for 4 rows, and every element passes through shared memory
// once a stage each way.

#pragma once

#include "fft_stages.cuh"
#include "lane_dft.cuh"
#include "line_fft.cuh"

namespace tpufft_minor {

using namespace tpufft_fft;

constexpr int kPackedElems = 4096;  // rows * n of a block of short rows

// Block b transforms rows [b*rows, b*rows + rows) of the (batch, n) planes;
// the ragged last block computes on zero rows and stores only real ones.
// blockDim.x <= kThreads and rows * n <= kPer * blockDim.x.
//
// kPadded (K9, the zero-pad DFT of tpufft's _build_minor_rect with
// m_in = n_in < m_out = den = n): the input rows are n_in long (row stride
// n_in), and columns n_in..n-1 load as zeros, so the pad never touches
// device memory. Only the load differs; without kPadded, n_in is unused and
// the kernel is K1's.
// kFused (K20, tpufft's _build_minor_fused): the rows are fused storage,
// (batch, 2n) with each row [re | im], h = n (fft_stages.cuh); only the
// load and the store differ from K1.
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
minor_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ yr, T* __restrict__ yi,
                 const float2* __restrict__ tw, int64_t batch, Radices plan,
                 int rows, int n_in, int inverse, float scale) {
  static_assert(!(kPadded && kFused), "no fused zero-pad form");
  extern __shared__ float2 tpufft_minor_smem[];
  float2* buf = tpufft_minor_smem;
  const int n = plan.n;
  const Div by_n(n);  // the fused IO's column of e (e < 16384)
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t here = batch - row0 < rows ? batch - row0 : rows;
  const int64_t base = row0 * n;
  const int total = rows * n;
  const int valid = (int)(here * n);
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.f, 0.f);
    if (kPadded) {
      const int r = e / n, c = e - r * n;
      const int64_t src = (row0 + r) * n_in + c;
      if (e < valid && c < n_in)
        v[k] = make_float2(load_f(xr, src), load_f(xi, src));
    } else if (e < valid) {
      const int64_t g =
          kFused ? fused_index(base + e, e - by_n(e) * n) : base + e;
      v[k] = make_float2(load_f(xr, g), load_f(xi, g));
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) buf[pad(e)] = v[k];
  }
  __syncthreads();
  run_stages<kPer>(buf, tw, plan, rows, inverse != 0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < valid) {
      const float2 w = buf[pad(e)];
      const int64_t g =
          kFused ? fused_index(base + e, e - by_n(e) * n) : base + e;
      store_f(yr, g, w.x * scale);
      store_f(yi, g, w.y * scale);
    }
  }
}

// Launch geometry for `elems` contiguous elements per unit (a row of n, or
// a pair slice of n1*n2): units per block, values per thread (the kernel's
// kPer), threads per block, and dynamic shared memory in bytes.
struct Geometry {
  int rows, per, threads;
  size_t smem;
};

inline Geometry launch_geometry(int n) {
  Geometry g;
  g.rows = n >= kPackedElems ? 1 : kPackedElems / n;
  g.per = n > kPackedElems ? 16 : 8;
  const int elems = g.rows * n;
  g.threads = ((elems + g.per - 1) / g.per + 31) / 32 * 32;
  g.smem = (size_t)pad(elems) * sizeof(float2);
  return g;
}

// ---------------------------------------------------------------------------
// The line form (the header's first form).
// ---------------------------------------------------------------------------

constexpr int kLineLaneValues = 32;  // complex values a lane holds
// the longest power-of-two row of K1's line form, and of the half of
// K7/K8's (real_fft.cu, r2c_line_form)
constexpr int kLineMaxN = 4096;

// Logical element `col` of row `row` (row length n): split planes, or fused
// rows [re | im] of 2n (fft_stages.cuh, fused_index; col = g mod n).
template <bool kFused>
__device__ __forceinline__ int64_t line_index(int64_t row, int n, int col) {
  const int64_t g = row * n + col;
  return kFused ? fused_index(g, col) : g;
}

template <typename T, bool kFused>
__device__ __forceinline__ float2 line_load(const T* __restrict__ xr,
                                            const T* __restrict__ xi,
                                            int64_t row, int n, int col) {
  const int64_t g = line_index<kFused>(row, n, col);
  return make_float2(load_f(xr, g), load_f(xi, g));
}

template <typename T, bool kFused>
__device__ __forceinline__ void line_store(T* __restrict__ yr,
                                           T* __restrict__ yi, int64_t row,
                                           int n, int col, float2 v,
                                           float scale) {
  const int64_t g = line_index<kFused>(row, n, col);
  store_f(yr, g, v.x * scale);
  store_f(yi, g, v.y * scale);
}

// The line form's load: element `col` of input row `row`. K1 and K20 read
// rows of n (line_index). K9 (kPadded) reads rows of n_in, the input's own
// row stride, at row n_in + col, and only where col < n_in: the pad is 0
// in the register and issues no memory request.
template <typename T, bool kFused, bool kPadded>
__device__ __forceinline__ float2 row_load(const T* __restrict__ xr,
                                          const T* __restrict__ xi,
                                          int64_t row, int n, int n_in,
                                          int col) {
  static_assert(!(kPadded && kFused), "no fused zero-pad form");
  if constexpr (kPadded) {
    if (col >= n_in) return make_float2(0.f, 0.f);
    const int64_t g = row * n_in + col;
    return make_float2(load_f(xr, g), load_f(xi, g));
  } else {
    return line_load<T, kFused>(xr, xi, row, n, col);
  }
}

// n <= 64: warp w of block b holds rows [(b warps + w) R, + R), R = W K: lane
// (l, c) holds row c + W k for k < K, each as Line<N> (line_fft.cuh). Rows
// past the batch compute on zeros and store nothing. The body of
// minor_lines_kernel (K1, K20) and minor_lines_padded_kernel (K9, input
// rows of n_in; n_in = N otherwise).
template <typename T, int N, int kThreads, bool kFused, bool kPadded>
__device__ __forceinline__ void lines_rows(
    const T* __restrict__ xr, const T* __restrict__ xi, T* __restrict__ yr,
    T* __restrict__ yi, const float2* __restrict__ tw, int64_t batch,
    int n_in, int inverse, float scale) {
  using L = tpufft_line::Line<N>;
  constexpr int K = kLineLaneValues / L::V;
  const int lane = threadIdx.x & 31, l = lane / L::W, c = lane % L::W;
  const int64_t row0 =
      ((int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * L::W * K;
  const bool inv = inverse != 0;
  float2 v[K][L::V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t row = row0 + c + L::W * k;
#pragma unroll
    for (int j = 0; j < L::V; ++j)
      v[k][j] = row < batch ? row_load<T, kFused, kPadded>(xr, xi, row, N,
                                                           n_in, L::in(l, j))
                            : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) tpufft_line::line_fft<N>(v[k], l, tw, inv);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t row = row0 + c + L::W * k;
    if (row < batch) {
#pragma unroll
      for (int q = 0; q < L::V; ++q)
        line_store<T, kFused>(yr, yi, row, N, L::out(l, q), v[k][q], scale);
    }
  }
}

template <typename T, int N, int kThreads, bool kFused>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
minor_lines_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                   T* __restrict__ yr, T* __restrict__ yi,
                   const float2* __restrict__ tw, int64_t batch, int inverse,
                   float scale) {
  lines_rows<T, N, kThreads, kFused, false>(xr, xi, yr, yi, tw, batch, N,
                                            inverse, scale);
}

// K9 at n <= 64: (batch, n_in) rows, 1 <= n_in < N, zero-padded to N.
template <typename T, int N, int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
minor_lines_padded_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                          T* __restrict__ yr, T* __restrict__ yi,
                          const float2* __restrict__ tw, int64_t batch,
                          int n_in, int inverse, float scale) {
  lines_rows<T, N, kThreads, false, true>(xr, xi, yr, yi, tw, batch, n_in,
                                          inverse, scale);
}

// ---- the four-step: whole lines in a lane ----

using tpufft_lane::lane_dft;
using tpufft_lane::lane_dft_emit;
using tpufft_lane::lane_out;
using tpufft_lane::max_prime;
using tpufft_lane::pair_dft;
using tpufft_lane::pair_out;

// The geometry of the four-step at n = N1 N2 by a team of kTeamWarps warps
// (lanes = 32 kTeamWarps) holding kRows rows. Pass 1's lines are the
// columns j2 of the (N1, N2) view of each row, pass 2's the rows k1; a line
// of up to 32 values lies in one lane, an even one of 34 to 64 on a lane
// pair (pair_dft). Pass 1 numbers its lines in slots u = r Q1 + j2 (Q1 >=
// N2 slots a row, those at j2 >= N2 idle), pass 2 in slots r Q2 + k1; lane
// t of the team takes slot t + lanes s in round s (on a pair, slot (t mod
// 16) + 16 (t / 32) + lanes / 2 s), every round's values held at once.
// The tile holds element (k1, j2) of the team's row r at
// - kP2 == 0 (power-of-two n): r n + k1 N2 + (j2 ^ ((k1 + N1 r) mod 16)),
//   half a warp writing 16 consecutive columns j2 of one k1 in pass 1 and
//   reading one j2 of 16 consecutive lines k1 + N1 r in pass 2;
// - else: r kRS + k1 kP2 + j2 (kRS >= N1 kP2), with kQ1, kQ2, kP2 and kRS
//   picked so that every half warp's accesses of both passes hit 16
//   distinct bank pairs (mod 16 positions).
// The wrapper's line_geometry lists every length's parameters and a CPU
// test (tests/test_torch_kernel_minor.py) walks each geometry's tile.
template <int kN1, int kN2, int kTeamWarps, int kThreads,
          int kRows = 1024 * kTeamWarps / (kN1 * kN2), int kQ1 = kN2,
          int kQ2 = kN1, int kP2 = 0, int kRS = 0>
struct LaneStep {
  static constexpr int N1 = kN1, N2 = kN2, n = kN1 * kN2;
  static constexpr int Q1 = kQ1, Q2 = kQ2;               // slots a row
  static constexpr int lanes = 32 * kTeamWarps;          // of a team
  static constexpr int rows = kRows;                     // a team holds
  static constexpr bool pair1 = N1 > 32, pair2 = N2 > 32;
  static constexpr int V1 = pair1 ? N1 / 2 : N1;         // values a line
  static constexpr int V2 = pair2 ? N2 / 2 : N2;         // holds in a lane
  static constexpr int units1 = pair1 ? lanes / 2 : lanes;
  static constexpr int units2 = pair2 ? lanes / 2 : lanes;
  static constexpr int S1 = (rows * kQ1 + units1 - 1) / units1;  // rounds
  static constexpr int S2 = (rows * kQ2 + units2 - 1) / units2;
  static constexpr int L1 = S1, L2 = S2;  // lines a lane holds (32 values)
  // every slot of every round a line: no guard
  static constexpr bool full1 = kQ1 == N2 && S1 * units1 == rows * kQ1;
  static constexpr bool full2 = kQ2 == N1 && S2 * units2 == rows * kQ2;
  static constexpr bool kXor = kP2 == 0;
  // a line whose largest prime is 7 or more hands its outputs over as it
  // forms them (lane_dft_emit)
  static constexpr bool emit1 = max_prime(N1) >= 7;
  static constexpr bool emit2 = max_prime(N2) >= 7;
  static constexpr int teams = kThreads / lanes;
  static constexpr int table = n + n / 16;               // pad(n) float2
  static constexpr int tile = kXor ? rows * n : rows * kRS;  // a team's
  static constexpr size_t smem = (size_t)(table + teams * tile) * 8;
  static_assert(kXor ? (N1 >= 8 && N2 >= 16 && N2 <= 64 &&
                        rows * n == 1024 * kTeamWarps &&
                        kQ1 == N2 && kQ2 == N1)
                     : (kQ1 >= N2 && kQ2 >= N1 && kP2 >= N2 &&
                        kRS >= N1 * kP2),
                "lane split");
  static_assert((!pair1 || N1 % 4 == 0) && (!pair2 || N2 % 4 == 0) &&
                    N1 <= 64 && N2 <= 64,
                "a line of 34 to 64 lies on a lane pair");
  static_assert(!(pair1 && emit1) && !(pair2 && emit2),
                "a pair line's primes are 2, 3 and 5");
  static_assert(teams * lanes == kThreads && teams <= 15, "teams");

  // m = k1 + N1 r, the pass-2 line of (r, k1): its low bits are the XOR's
  static __device__ __forceinline__ int pos(int r, int k1, int j2, int m) {
    if constexpr (kXor)
      return r * n + k1 * N2 + (j2 ^ (m & 15));
    else
      return r * kRS + k1 * kP2 + j2;
  }
};

// The index in its line of register r of a transformed line of N: in one
// lane, or on a pair (N > 32) at place p.
template <int N>
__device__ __forceinline__ int line_out(int p, int r) {
  if constexpr (N > 32)
    return pair_out<N / 2>(p, r);
  else
    return lane_out<N>(r);
}

// Slot s of team lane t in a pass (a line on a pair: both lanes' slot).
template <bool kPair, int kLanes>
__device__ __forceinline__ int lane_line(int t, int s) {
  return kPair ? (t & 15) + 16 * (t >> 5) + (kLanes / 2) * s
               : t + kLanes * s;
}

// The DFT of a line of N in registers v (one lane, or a pair at place p),
// n / N the table stride of W_N.
template <int N, int kStride, int V>
__device__ __forceinline__ void line_dft(float2 (&v)[V], int p,
                                         const float2* table, bool inv) {
  if constexpr (N > 32)
    pair_dft<N / 2, kStride>(v, p, table, inv);
  else
    lane_dft<N, kStride, 0, 1>(v, table, inv);
}

// Blocks of the lane kernel an SM must hold: five of 128 threads (at most
// 102 registers; the compiler takes 92-96 at n = 128 to 2048, with no
// spill), two of 256 (K7/K8's half m = 4096: 128). On the H100, five beat
// four at n = 2048 and tied at 1024 (PERF.md); no bound (up to 240
// registers) lost.
__host__ __device__ constexpr int kLaneMinBlocks(int threads) {
  return threads == 128 ? 5 : 2;
}

// The grid of a kernel whose blocks loop over `groups` row groups: at most
// the blocks the card holds at once, so that each block stages its table
// once. Returns cudaSuccess with *blocks >= 1, or the CUDA error.
template <typename Kernel>
inline cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                                 long long groups, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  *blocks = (unsigned)(groups < resident ? groups : resident);
  return cudaSuccess;
}

// The team's barrier between the passes: __syncwarp for one warp, else
// named barrier 1 + team (barrier 0 is __syncthreads').
template <int kTeamWarps>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (kTeamWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kTeamWarps * 32)
                 : "memory");
}

// The four-step (n = 128 .. 2048 at powers of two, every mixed-radix
// length of the form; LaneStep S): block b stages the table, then takes
// row groups b, b + gridDim.x, ...; team e of a group transforms rows
// [(group teams + e) R, + R). Pass 1: the lines are the columns j2 of the
// (N1, N2) view, lane t holding the slots of S's rounds with register j1
// holding x[N2 j1 + j2] (on a pair register i holds x[N2 (p + 2 i) + j2]):
// a warp's load instruction reads consecutive elements of a row (32 at n =
// 1024). Each output Y[k1, j2] times w^(k1 j2) goes into the tile. Pass 2:
// the lines are the rows k1 in the same arrangement, register j2 (or p + 2
// i) holding Y'[k1, j2], handed over as X[k1 + N1 k2]. Rows past the batch
// and idle slots compute on zeros and hand over nothing.
//
// Where pass 1's values come from and where pass 2's go is the caller's
// policy `io` (RowIo below for K1, K20 and K9; the real-input kernels of
// real_fft.cuh read packed or real rows, or a tangled tile, and untangle
// or store halves):
// - io.begin(tile, t, team, row0): before pass 1 of each row group;
// - io.load(tile, r, row, col): element col of the group's row r (device
//   row `row`) into pass 1, on live slots of rows inside the batch;
// - io.held1(team), io.held2(team): after each pass's reads (and its line
//   DFTs where they run apart from the hand-over), before its writes;
// - io.put(tile, r, row, k, y): X[k] of row r, on live slots of rows
//   inside the batch;
// - io.end(tile, t, team, row0): after pass 2, before the group's last
//   team barrier.
template <typename S, int kThreads, class Io>
__device__ __forceinline__ void lane_steps(Io& io,
                                           const float2* __restrict__ tw,
                                           int64_t batch, int inverse) {
  constexpr int n = S::n, N1 = S::N1, N2 = S::N2, R = S::rows;
  constexpr int kTeamWarps = S::lanes / 32;
  extern __shared__ float2 tpufft_lane_smem[];
  float2* table = tpufft_lane_smem;
  const int team = threadIdx.x / S::lanes;
  const int t = threadIdx.x - team * S::lanes;
  const int p = (t >> 4) & 1;  // place in a lane pair
  float2* tile = table + S::table + team * S::tile;
  const bool inv = inverse != 0;
  for (int i = threadIdx.x; i < n; i += kThreads) table[pad(i)] = __ldg(&tw[i]);
  __syncthreads();
  const int64_t groups = (batch + S::teams * R - 1) / (S::teams * R);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * S::teams + team) * R;
    io.begin(tile, t, team, row0);
    {  // pass 1: the columns, from the caller's rows into the tile
      constexpr int V = S::V1;
      float2 v[S::S1][V];
#pragma unroll
      for (int s = 0; s < S::S1; ++s) {
        const int slot = lane_line<S::pair1, S::lanes>(t, s);
        const int r = slot / S::Q1, j2 = slot % S::Q1;
        const int64_t row = row0 + r;
        const bool live = S::full1 || (r < R && j2 < N2);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int j1 = S::pair1 ? p + 2 * j : j;
          v[s][j] = live && row < batch ? io.load(tile, r, row, N2 * j1 + j2)
                                        : make_float2(0.f, 0.f);
        }
      }
      if constexpr (!S::emit1) {
#pragma unroll
        for (int s = 0; s < S::S1; ++s)
          line_dft<N1, n / N1>(v[s], p, table, inv);
      }
      io.held1(team);
#pragma unroll
      for (int s = 0; s < S::S1; ++s) {
        const int slot = lane_line<S::pair1, S::lanes>(t, s);
        const int r = slot / S::Q1, j2 = slot % S::Q1;
        const bool live = S::full1 || (r < R && j2 < N2);
        auto put = [&](int k1, float2 y) {
          if (live)
            tile[S::pos(r, k1, j2, k1 + N1 * r)] =
                cmul(y, table[pad(k1 * j2)]);
        };
        if constexpr (S::emit1) {
          lane_dft_emit<N1, n / N1, 0, 1>(v[s], table, inv, put);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) put(line_out<N1>(p, q), v[s][q]);
        }
      }
    }
    team_sync<kTeamWarps>(team);
    {  // pass 2: the rows k1 of the tile, handed to the caller
      constexpr int V = S::V2;
      float2 v[S::S2][V];
#pragma unroll
      for (int s = 0; s < S::S2; ++s) {
        const int slot = lane_line<S::pair2, S::lanes>(t, s);
        const int r = slot / S::Q2, k1 = slot % S::Q2;
        const bool live = S::full2 || (r < R && k1 < N1);
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[s][j] = live
                        ? tile[S::pos(r, k1, S::pair2 ? p + 2 * j : j, slot)]
                         : make_float2(0.f, 0.f);
      }
      if constexpr (!S::emit2) {
#pragma unroll
        for (int s = 0; s < S::S2; ++s)
          line_dft<N2, n / N2>(v[s], p, table, inv);
      }
      io.held2(team);
#pragma unroll
      for (int s = 0; s < S::S2; ++s) {
        const int slot = lane_line<S::pair2, S::lanes>(t, s);
        const int r = slot / S::Q2, k1 = slot % S::Q2;
        const int64_t row = row0 + r;
        const bool live = (S::full2 || (r < R && k1 < N1)) && row < batch;
        auto put = [&](int k2, float2 y) {
          if (live) io.put(tile, r, row, k1 + N1 * k2, y);
        };
        if constexpr (S::emit2) {
          lane_dft_emit<N2, n / N2, 0, 1>(v[s], table, inv, put);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) put(line_out<N2>(p, q), v[s][q]);
        }
      }
    }
    io.end(tile, t, team, row0);
    team_sync<kTeamWarps>(team);  // the tile is read before it is rewritten
  }
}

// lane_steps' policy for K1, K20 and K9: rows of n read from device memory
// (K9: rows of n_in, zero-padded; row_load) and X stored to rows of n
// times scale (line_store).
template <typename T, int kN, bool kFused, bool kPadded>
struct RowIo {
  const T* __restrict__ xr;
  const T* __restrict__ xi;
  T* __restrict__ yr;
  T* __restrict__ yi;
  int n_in;
  float scale;
  __device__ __forceinline__ void begin(float2*, int, int, int64_t) {}
  __device__ __forceinline__ float2 load(const float2*, int, int64_t row,
                                         int col) const {
    return row_load<T, kFused, kPadded>(xr, xi, row, kN, n_in, col);
  }
  __device__ __forceinline__ void held1(int) {}
  __device__ __forceinline__ void held2(int) {}
  __device__ __forceinline__ void put(float2*, int, int64_t row, int k,
                                      float2 y) const {
    line_store<T, kFused>(yr, yi, row, kN, k, y, scale);
  }
  __device__ __forceinline__ void end(float2*, int, int, int64_t) {}
};

// The body of minor_lane_kernel (K1, K20) and minor_lane_padded_kernel (K9:
// input rows of n_in, so pass 1's register j1 of column j2 is 0 for N2 j1
// + j2 >= n_in; n_in = n otherwise): lane_steps on RowIo.
template <typename T, typename S, int kThreads, bool kFused, bool kPadded>
__device__ __forceinline__ void lane_rows(
    const T* __restrict__ xr, const T* __restrict__ xi, T* __restrict__ yr,
    T* __restrict__ yi, const float2* __restrict__ tw, int64_t batch,
    int n_in, int inverse, float scale) {
  RowIo<T, S::n, kFused, kPadded> io{xr, xi, yr, yi, n_in, scale};
  lane_steps<S, kThreads>(io, tw, batch, inverse);
}

// Blocks of the lane kernel an SM must hold: the power-of-two geometries
// as kLaneMinBlocks says; the mixed-radix ones four of 128 threads (at
// most 128 registers: a lane holds up to 36 values a pass), three (168)
// where a line lies on a lane pair. On the H100 three took K1 at 1080 and
// 2160 from 0.200-0.226 to 0.169-0.189 and 0.107-0.135 to 0.098-0.113 ms
// (their 32-132 bytes of spills gone) and tied at 480; 93, whose lines
// are in one lane, kept four (0.61-0.64 against 0.61-0.67 ms at three;
// PERF.md; tools/split_plane_ab.py on patched copies).
template <typename S, int kThreads>
__host__ __device__ constexpr int lane_min_blocks() {
  return S::kXor ? kLaneMinBlocks(kThreads) : S::pair1 || S::pair2 ? 3 : 4;
}

template <typename T, typename S, int kThreads, bool kFused>
__global__ void __launch_bounds__(kThreads, (lane_min_blocks<S, kThreads>()))
minor_lane_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ yr, T* __restrict__ yi,
                  const float2* __restrict__ tw, int64_t batch, int inverse,
                  float scale) {
  lane_rows<T, S, kThreads, kFused, false>(xr, xi, yr, yi, tw, batch, S::n,
                                           inverse, scale);
}

// K9 on the four-step: (batch, n_in) rows, 1 <= n_in < n, zero-padded to
// n = N1 N2.
template <typename T, typename S, int kThreads>
__global__ void __launch_bounds__(kThreads, (lane_min_blocks<S, kThreads>()))
minor_lane_padded_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                         T* __restrict__ yr, T* __restrict__ yi,
                         const float2* __restrict__ tw, int64_t batch,
                         int n_in, int inverse, float scale) {
  lane_rows<T, S, kThreads, false, true>(xr, xi, yr, yi, tw, batch, n_in,
                                         inverse, scale);
}

// ---- host: the four-step's launch ----

// One launch's operands (minor_fft.cu fills it).
struct LaneArgs {
  const void *xr, *xi;
  void *yr, *yi;
  const void* tw;
  long long batch;
  int n_in, inverse;
  float scale;
  cudaStream_t stream;
};

// The four-step of geometry S on a grid of at most the blocks the card
// holds at once (each stages the table once and loops over row groups);
// K9 (kPadded) runs the padded kernel.
template <typename T, typename S, int kThreads, bool kFused, bool kPadded>
int launch_four_step(const LaneArgs& a) {
  constexpr long long rows = S::teams * S::rows;
  const long long groups = (a.batch + rows - 1) / rows;
  const T* x_r = static_cast<const T*>(a.xr);
  const T* x_i = static_cast<const T*>(a.xi);
  T* y_r = static_cast<T*>(a.yr);
  T* y_i = static_cast<T*>(a.yi);
  const float2* w = static_cast<const float2*>(a.tw);
  unsigned blocks = 0;
  cudaError_t err;
  if constexpr (kPadded) {
    auto* kernel = minor_lane_padded_kernel<T, S, kThreads>;
    err = allow_smem(kernel, S::smem);
    if (err == cudaSuccess)
      err = resident_grid(kernel, kThreads, S::smem, groups, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, S::smem, a.stream>>>(
        x_r, x_i, y_r, y_i, w, (int64_t)a.batch, a.n_in, a.inverse, a.scale);
  } else {
    auto* kernel = minor_lane_kernel<T, S, kThreads, kFused>;
    err = allow_smem(kernel, S::smem);
    if (err == cudaSuccess)
      err = resident_grid(kernel, kThreads, S::smem, groups, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, S::smem, a.stream>>>(
        x_r, x_i, y_r, y_i, w, (int64_t)a.batch, a.inverse, a.scale);
  }
  return (int)cudaGetLastError();
}

// ---- the three-factor line form: n = N1 N2 N3 from 4096 ----

// Rounds of a pass whose values a lane holds at once: as many lines of N
// as 32 values take, at least one, at most the pass's S rounds.
__host__ __device__ constexpr int long_hold(int N, int S) {
  return 32 / N < 1 ? 1 : 32 / N < S ? 32 / N : S;
}

// The geometry of the three-factor form at n = N1 N2 N3 (each at most 32,
// whole in one lane) by a block of kThreads threads, one row at a time.
// With M = N2 N3 and u = N3 j2 + j3:
// - pass 1 transforms the M columns u of the (N1, M) view (x[M j1 + u]),
//   lanes on consecutive u, and writes Y[k1, u] w^(k1 u) to (k1, j2, j3);
// - pass 2 the N1 N3 lines (k1, j3) over j2, in place, lanes on
//   consecutive j3 (then k1), times w_M^(k2 j3);
// - pass 3 the N1 N2 lines v = k1 + N1 k2 over j3, lanes on consecutive v,
//   stored at X[v + N1 N2 k3].
// Line l of a pass goes to lane t = l mod kThreads in round l / kThreads.
// The tile holds (k1, c2, j3) (c2 = j2, then k2) at k1 kP1 + c2 kP2 + j3,
// kP1 and kP2 picked so that every half warp of the three passes touches
// 16 distinct bank pairs. In front of it, the twiddles (float2):
// the line tables W_N1, W_N2, W_N3 at pad(m) (lane_dft's), then A[k1][j2]
// = w^(k1 j2 N3), B[k1][j3] = w^(k1 j3) and C[k2][j3] = w^(N1 k2 j3) =
// w_M^(k2 j3), all read from the n-table: pass 1's w^(k1 u) is A B.
// The wrapper's line_geometry lists every length's parameters and a CPU
// test (tests/test_torch_kernel_minor.py) walks each geometry's tile.
template <int kN1, int kN2, int kN3, int kThreads, int kP1, int kP2>
struct LongStep {
  static constexpr int N1 = kN1, N2 = kN2, N3 = kN3, n = kN1 * kN2 * kN3;
  static constexpr int threads = kThreads, P1 = kP1, P2 = kP2;
  static constexpr int lines1 = N2 * N3, lines2 = N1 * N3, lines3 = N1 * N2;
  static constexpr int S1 = (lines1 + kThreads - 1) / kThreads;  // rounds
  static constexpr int S2 = (lines2 + kThreads - 1) / kThreads;
  static constexpr int S3 = (lines3 + kThreads - 1) / kThreads;
  static constexpr int H1 = long_hold(N1, S1), H2 = long_hold(N2, S2),
                       H3 = long_hold(N3, S3);
  static constexpr bool emit1 = max_prime(N1) >= 7;
  static constexpr bool emit2 = max_prime(N2) >= 7;
  static constexpr bool emit3 = max_prime(N3) >= 7;
  static constexpr int w1 = 0, w2 = w1 + N1 + N1 / 16 + 1,
                       w3 = w2 + N2 + N2 / 16 + 1,
                       ta = w3 + N3 + N3 / 16 + 1, tb = ta + N1 * N2,
                       tc = tb + N1 * N3, table = tc + N2 * N3;
  static constexpr int tile = N1 * kP1;
  static constexpr size_t smem = (size_t)(table + tile) * 8;
  // at most 128 registers: two blocks of 256 threads an SM, one of 512
  static constexpr int min_blocks = 512 / kThreads < 1 ? 1 : 512 / kThreads;
  static_assert(N1 <= 32 && N2 <= 32 && N3 <= 32 && kThreads % 32 == 0,
                "lines whole in a lane");
  static_assert(kP2 >= N3 && kP1 >= N2 * kP2, "tile");

  static __device__ __forceinline__ int pos(int k1, int c2, int j3) {
    return k1 * kP1 + c2 * kP2 + j3;
  }
};

// The DFT of the line of N in v (one lane), its outputs handed to put(k,
// X[k]) once each: lane_dft, or lane_dft_emit where N has a prime from 7.
// w is the table of W_N^m at pad(m).
template <int N, bool kEmit, typename Put>
__device__ __forceinline__ void long_line(float2 (&v)[N], const float2* w,
                                          bool inv, const Put& put) {
  if constexpr (kEmit) {
    lane_dft_emit<N, 1, 0, 1>(v, w, inv, put);
  } else {
    lane_dft<N, 1, 0, 1>(v, w, inv);
#pragma unroll
    for (int q = 0; q < N; ++q) put(lane_out<N>(q), v[q]);
  }
}

// Pass 1's twiddle w^(k1 (N3 j2 + j3)), k1 > 0: A[k1][j2] B[k1][j3].
template <typename S>
__device__ __forceinline__ float2 long_twiddle(const float2* table, int k1,
                                               int j2, int j3) {
  return cmul(table[S::ta + k1 * S::N2 + j2], table[S::tb + k1 * S::N3 + j3]);
}

// The three-factor form (LongStep S): block b stages the twiddles, then
// transforms rows b, b + gridDim.x, ...: pass 1 from device memory into
// the tile, a barrier, pass 2 in the tile, a barrier, pass 3 from the tile
// to device memory, and a barrier before the next row's pass 1. A pass
// takes its rounds H at a time (all their values held at once); a warp
// whose lines of a round all lie past the pass's lines skips the round.
// K9 (kPadded) reads rows of n_in, so pass 1's register j1 of column u is
// 0 for M j1 + u >= n_in; n_in = n otherwise.
template <typename T, typename S, bool kFused, bool kPadded>
__global__ void __launch_bounds__(S::threads, S::min_blocks)
minor_long_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ yr, T* __restrict__ yi,
                  const float2* __restrict__ tw, int64_t batch, int n_in,
                  int inverse, float scale) {
  constexpr int n = S::n, N1 = S::N1, N2 = S::N2, N3 = S::N3;
  constexpr int TH = S::threads;
  extern __shared__ float2 tpufft_long_smem[];
  float2* table = tpufft_long_smem;
  float2* tile = table + S::table;
  const int t = threadIdx.x, warp0 = t & ~31;
  const bool inv = inverse != 0;
  for (int m = t; m < N1; m += TH)
    table[S::w1 + pad(m)] = __ldg(&tw[m * (n / N1)]);
  for (int m = t; m < N2; m += TH)
    table[S::w2 + pad(m)] = __ldg(&tw[m * (n / N2)]);
  for (int m = t; m < N3; m += TH)
    table[S::w3 + pad(m)] = __ldg(&tw[m * (n / N3)]);
  for (int i = t; i < N1 * N2; i += TH)
    table[S::ta + i] = __ldg(&tw[(i / N2) * (i % N2) * N3]);
  for (int i = t; i < N1 * N3; i += TH)
    table[S::tb + i] = __ldg(&tw[(i / N3) * (i % N3)]);
  for (int i = t; i < N2 * N3; i += TH)
    table[S::tc + i] = __ldg(&tw[N1 * (i / N3) * (i % N3)]);
  __syncthreads();
  for (int64_t row = blockIdx.x; row < batch; row += gridDim.x) {
#pragma unroll
    for (int c = 0; c < S::S1; c += S::H1) {  // pass 1: columns u
      float2 v[S::H1][N1];
#pragma unroll
      for (int h = 0; h < S::H1; ++h) {
        const int u = t + TH * (c + h);
        const bool live = c + h < S::S1 && u < S::lines1;
#pragma unroll
        for (int j = 0; j < N1; ++j)
          v[h][j] = live ? row_load<T, kFused, kPadded>(xr, xi, row, n, n_in,
                                                        S::lines1 * j + u)
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < S::H1; ++h) {
        const int u = t + TH * (c + h);
        if (c + h >= S::S1 || warp0 + TH * (c + h) >= S::lines1) continue;
        const int j2 = u / N3, j3 = u - j2 * N3;
        const bool live = u < S::lines1;
        long_line<N1, S::emit1>(v[h], table + S::w1, inv,
                                [&](int k1, float2 y) {
          if (live)
            tile[S::pos(k1, j2, j3)] =
                k1 == 0 ? y : cmul(y, long_twiddle<S>(table, k1, j2, j3));
        });
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < S::S2; c += S::H2) {  // pass 2: lines (k1, j3)
      float2 v[S::H2][N2];
#pragma unroll
      for (int h = 0; h < S::H2; ++h) {
        const int w = t + TH * (c + h);
        const bool live = c + h < S::S2 && w < S::lines2;
        const int k1 = w / N3, j3 = w - k1 * N3;
#pragma unroll
        for (int j = 0; j < N2; ++j)
          v[h][j] = live ? tile[S::pos(k1, j, j3)] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < S::H2; ++h) {
        const int w = t + TH * (c + h);
        if (c + h >= S::S2 || warp0 + TH * (c + h) >= S::lines2) continue;
        const int k1 = w / N3, j3 = w - k1 * N3;
        const bool live = w < S::lines2;
        long_line<N2, S::emit2>(v[h], table + S::w2, inv,
                                [&](int k2, float2 y) {
          if (live)
            tile[S::pos(k1, k2, j3)] =
                k2 == 0 ? y : cmul(y, table[S::tc + k2 * N3 + j3]);
        });
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < S::S3; c += S::H3) {  // pass 3: lines k1 + N1 k2
      float2 v[S::H3][N3];
#pragma unroll
      for (int h = 0; h < S::H3; ++h) {
        const int l = t + TH * (c + h);
        const bool live = c + h < S::S3 && l < S::lines3;
        const int k2 = l / N1, k1 = l - k2 * N1;
#pragma unroll
        for (int j = 0; j < N3; ++j)
          v[h][j] = live ? tile[S::pos(k1, k2, j)] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < S::H3; ++h) {
        const int l = t + TH * (c + h);
        if (c + h >= S::S3 || warp0 + TH * (c + h) >= S::lines3) continue;
        const bool live = l < S::lines3;
        long_line<N3, S::emit3>(v[h], table + S::w3, inv,
                                [&](int k3, float2 y) {
          if (live)
            line_store<T, kFused>(yr, yi, row, n, l + S::lines3 * k3, y,
                                  scale);
        });
      }
    }
    __syncthreads();  // the tile is read before the next row rewrites it
  }
}

// The three-factor form of geometry S on a grid of at most the blocks the
// card holds at once, each looping over rows (K9 with kPadded).
template <typename T, typename S, bool kFused, bool kPadded>
int launch_three_factor(const LaneArgs& a) {
  auto* kernel = minor_long_kernel<T, S, kFused, kPadded>;
  unsigned blocks = 0;
  cudaError_t err = allow_smem(kernel, S::smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, S::threads, S::smem, a.batch, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, S::threads, S::smem, a.stream>>>(
      static_cast<const T*>(a.xr), static_cast<const T*>(a.xi),
      static_cast<T*>(a.yr), static_cast<T*>(a.yi),
      static_cast<const float2*>(a.tw), (int64_t)a.batch, a.n_in, a.inverse,
      a.scale);
  return (int)cudaGetLastError();
}

// The mixed-radix lengths of the line form, one list a radix family (each
// instantiated by its own source, minor_line_{r3,r5,r15,odd}.cu, so that
// nvcc builds them in parallel): X(n, N1, N2, team warps, rows a team, Q1,
// Q2, P2, RS), LaneStep's parameters, every block 128 threads. The
// wrapper's table (kernels/minor_fft.py, _FOUR_STEP) lists the same
// geometries, and a CPU test holds the two lists equal.
// The power-of-two four-steps: X(n, N1, N2, warps a team, threads a
// block), 32 values a lane in the XOR tile (minor_fft.cu, launch_lane).
#define TPUFFT_MINOR_POW2(X) \
  X(128, 8, 16, 1, 128)      \
  X(256, 16, 16, 1, 128)     \
  X(512, 32, 16, 1, 128)     \
  X(1024, 32, 32, 1, 128)    \
  X(2048, 32, 64, 2, 128)
#define TPUFFT_MINOR_R3(X)          \
  X(12, 4, 3, 1, 64, 3, 4, 4, 19)   \
  X(24, 8, 3, 1, 32, 3, 8, 6, 51)   \
  X(48, 3, 16, 4, 85, 16, 3, 17, 51) \
  X(96, 6, 16, 1, 10, 16, 6, 17, 102) \
  X(192, 8, 24, 1, 4, 24, 8, 25, 200) \
  X(384, 8, 48, 1, 2, 48, 8, 49, 392) \
  X(768, 12, 64, 1, 1, 64, 12, 65, 780) \
  X(1536, 24, 64, 2, 1, 64, 24, 65, 1560) \
  X(3072, 48, 64, 4, 1, 64, 48, 65, 3120)
#define TPUFFT_MINOR_R5(X)          \
  X(20, 4, 5, 1, 56, 5, 4, 12, 53)  \
  X(40, 8, 5, 1, 19, 5, 8, 6, 53)   \
  X(80, 5, 16, 1, 12, 16, 5, 17, 85) \
  X(160, 5, 32, 1, 6, 32, 5, 33, 165) \
  X(320, 5, 64, 1, 3, 64, 5, 65, 325) \
  X(640, 10, 64, 2, 3, 64, 10, 65, 650) \
  X(1280, 20, 64, 2, 1, 64, 20, 65, 1300) \
  X(2560, 40, 64, 4, 1, 64, 40, 65, 2600)
#define TPUFFT_MINOR_R15(X)         \
  X(30, 2, 15, 1, 32, 16, 2, 15, 30) \
  X(60, 4, 15, 1, 16, 16, 4, 15, 60) \
  X(120, 8, 15, 1, 8, 16, 8, 15, 120) \
  X(240, 8, 30, 1, 4, 32, 8, 30, 241) \
  X(480, 8, 60, 1, 2, 64, 8, 61, 488) \
  X(960, 15, 64, 1, 1, 64, 15, 65, 975) \
  X(1920, 30, 64, 2, 1, 64, 30, 65, 1950) \
  X(3840, 60, 64, 4, 1, 64, 60, 65, 3900)
#define TPUFFT_MINOR_ODD(X)         \
  X(93, 31, 3, 1, 10, 3, 32, 3, 99) \
  X(1000, 25, 40, 2, 1, 40, 25, 41, 1025) \
  X(1080, 30, 36, 4, 3, 36, 32, 37, 1124) \
  X(2160, 36, 60, 4, 1, 60, 36, 61, 2196)
// The three-factor lengths (minor_line_long.cu): X(n, N1, N2, N3, threads
// a block, P1, P2), LongStep's parameters. At 4096, 16 x 16 x 16 took
// 0.96 ms on (40000, 4096) against 1.29 for the 64 x 64 four-step on lane
// pairs (PERF.md). Every other n in (4096, 16384] runs the stage form.
#define TPUFFT_MINOR_LONG(X)            \
  X(4096, 16, 16, 16, 256, 257, 16)     \
  X(4320, 15, 9, 32, 256, 303, 33)      \
  X(5120, 16, 10, 32, 256, 321, 32)     \
  X(6144, 16, 12, 32, 256, 385, 32)     \
  X(7680, 16, 15, 32, 256, 481, 32)     \
  X(8192, 16, 16, 32, 256, 513, 32)     \
  X(8320, 13, 20, 32, 256, 661, 33)     \
  X(10240, 16, 20, 32, 256, 641, 32)    \
  X(12288, 16, 24, 32, 256, 769, 32)    \
  X(15360, 16, 30, 32, 512, 961, 32)    \
  X(16384, 16, 32, 32, 512, 1025, 32)

// K1's four-step at the mixed-radix length n of the family lists:
// LaneStep's parameters read from them (the real-input kernels of
// real_fft.cuh run it at their half m, or at n itself for odd n).
struct MixedGeometry {
  int n1, n2, w, r, q1, q2, p2, rs;
};

constexpr MixedGeometry mixed_geometry(int n) {
#define TPUFFT_GEO_OF(n_, n1, n2, w, r, q1, q2, p2, rs) \
  if (n == n_) return MixedGeometry{n1, n2, w, r, q1, q2, p2, rs};
  TPUFFT_MINOR_R3(TPUFFT_GEO_OF)
  TPUFFT_MINOR_R5(TPUFFT_GEO_OF)
  TPUFFT_MINOR_R15(TPUFFT_GEO_OF)
  TPUFFT_MINOR_ODD(TPUFFT_GEO_OF)
#undef TPUFFT_GEO_OF
  return MixedGeometry{0, 0, 0, 0, 0, 0, 0, 0};
}

template <int n>
using MixedStep =
    LaneStep<mixed_geometry(n).n1, mixed_geometry(n).n2,
             mixed_geometry(n).w, 128, mixed_geometry(n).r,
             mixed_geometry(n).q1, mixed_geometry(n).q2,
             mixed_geometry(n).p2, mixed_geometry(n).rs>;

// The launchers of each family: the length's kernel in storage T (K1,
// K20 with kFused, K9 with kPadded), or cudaErrorInvalidValue for a length
// the family does not hold.
template <typename T, bool kFused, bool kPadded>
int launch_mixed_r3(const LaneArgs& a, int n);
template <typename T, bool kFused, bool kPadded>
int launch_mixed_r5(const LaneArgs& a, int n);
template <typename T, bool kFused, bool kPadded>
int launch_mixed_r15(const LaneArgs& a, int n);
template <typename T, bool kFused, bool kPadded>
int launch_mixed_odd(const LaneArgs& a, int n);
template <typename T, bool kFused, bool kPadded>
int launch_long(const LaneArgs& a, int n);

// Is n a length of the three-factor form (TPUFFT_MINOR_LONG)?
inline bool three_factor(int n) {
#define TPUFFT_IS(n_, ...) || n == n_
  return false TPUFFT_MINOR_LONG(TPUFFT_IS);
#undef TPUFFT_IS
}

// The family source that holds mixed-radix length n: 3, 5, 15 (n = r
// 2^a) or 1 (the odd list), 0 where n is not a mixed-radix length of the
// form.
inline int mixed_family(int n) {
#define TPUFFT_IS(n_, ...) || n == n_
  if (false TPUFFT_MINOR_R3(TPUFFT_IS)) return 3;
  if (false TPUFFT_MINOR_R5(TPUFFT_IS)) return 5;
  if (false TPUFFT_MINOR_R15(TPUFFT_IS)) return 15;
  if (false TPUFFT_MINOR_ODD(TPUFFT_IS)) return 1;
#undef TPUFFT_IS
  return 0;
}

template <typename T, bool kFused, bool kPadded>
int launch_mixed(const LaneArgs& a, int n) {
  switch (mixed_family(n)) {
    case 3: return launch_mixed_r3<T, kFused, kPadded>(a, n);
    case 5: return launch_mixed_r5<T, kFused, kPadded>(a, n);
    case 15: return launch_mixed_r15<T, kFused, kPadded>(a, n);
    case 1: return launch_mixed_odd<T, kFused, kPadded>(a, n);
  }
  return (int)cudaErrorInvalidValue;
}

// The body of each family's source: its switch over n and the launcher's
// six instantiations (f32 and bf16; K1, K20, K9).
#define TPUFFT_MINOR_CASE(n_, n1, n2, w, r, q1, q2, p2, rs)              \
  case n_:                                                              \
    return launch_four_step<T, LaneStep<n1, n2, w, 128, r, q1, q2, p2, rs>, \
                            128, kFused, kPadded>(a);
#define TPUFFT_MINOR_FAMILY(NAME, LIST)                                  \
  template <typename T, bool kFused, bool kPadded>                       \
  int NAME(const LaneArgs& a, int n) {                                   \
    switch (n) { LIST(TPUFFT_MINOR_CASE) }                               \
    return (int)cudaErrorInvalidValue;                                   \
  }                                                                      \
  template int NAME<float, false, false>(const LaneArgs&, int);          \
  template int NAME<float, true, false>(const LaneArgs&, int);           \
  template int NAME<float, false, true>(const LaneArgs&, int);           \
  template int NAME<__nv_bfloat16, false, false>(const LaneArgs&, int);  \
  template int NAME<__nv_bfloat16, true, false>(const LaneArgs&, int);   \
  template int NAME<__nv_bfloat16, false, true>(const LaneArgs&, int);

}  // namespace tpufft_minor
