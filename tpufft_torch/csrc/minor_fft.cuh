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
// The line form, for power-of-two n from 2 to 4096 (K1, K20, and K9 at
// any n_in < n): each row lives in registers and goes through shared
// memory at most once each way.
// - n <= 64 (minor_lines_kernel): a row is one line of line_fft.cuh, on
//   n/8 lanes of a warp that swap values by __shfl_xor_sync. Lane (l, c)
//   loads x[l + G j] of row c straight from device memory (8 consecutive
//   elements of 4 rows a warp instruction at n = 64) and stores X[out(l,
//   r)] the same way: no shared memory, no barrier.
// - 128 <= n <= 4096 (minor_lane_kernel): the four-step n = N1 N2 (N1,
//   N2 powers of two from 8 to 64; line_split in the wrapper) by a team
//   of one to four warps holding 32 values a lane. Pass 1 transforms the
//   N1-long column lines j2 of the (N1, N2) view of a row, each whole in
//   the registers of one lane (lane_fft: radix 8 or 4 twice, no exchange
//   between lanes; a 64-long line lies on a lane pair, pair_fft, which
//   swaps 16 values once), consecutive lanes on consecutive columns, so
//   that a warp's load instruction reads 32 consecutive elements (one
//   128-byte line in f32 at n = 1024). Each value Y[k1, j2] is multiplied
//   by w^(k1 j2), read at index k1 j2 of the table staged once a block in
//   shared memory, and written once into the team's tile. One team barrier
//   (__syncwarp, or a named barrier for several warps); pass 2 reads the
//   N2-long lines k1 back, consecutive lanes on consecutive k1, and stores
//   X[k1 + N1 k2] from registers, again 32 consecutive elements a store
//   instruction. The tile holds (k1, j2) of row r at r n + k1 N2 + (j2 ^
//   ((k1 + N1 r) mod 16)), which keeps both passes' shared accesses free
//   of bank conflicts (LaneStep below; the wrapper's line_geometry mirrors
//   it for a CPU test). At n = 1024 a team is one warp, a block four teams
//   (128 threads, ~41 KB of shared memory, at most 102 registers: five
//   blocks an SM); blocks loop over row groups, so that the table is
//   staged once per resident block, and after the staging no block-wide
//   barrier runs: the warps of an SM overlap one team's loads with
//   another's butterflies.
//   Every load and store is a 4-byte (2-byte in bf16) access, so a view
//   that does not start on a 16-byte boundary runs it too.
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
//
// The stage form (minor_fft_kernel), for every other length (K1, K20 and
// K9 alike, e.g. 93, 480, a pad 300 -> 384 or 5000 -> 8192): a
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
// The line form (power-of-two n from 2 to 4096; the header's first form).
// ---------------------------------------------------------------------------

constexpr int kLineLaneValues = 32;  // complex values a lane holds
constexpr int kLineMaxN = 4096;     // longest row of the line form

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

// ---- 128 <= n <= 4096: whole lines in a lane ----

// The in-register DFT of the N values (8, 16 or 32) one lane holds: N = A B
// with A = 8 (N = 8, 32) or 4 (N = 16); radix-A butterflies over x[b + B
// a] for each b, the twiddles w_N^(a b) read at pad(a b kStride) of the
// table staged in shared memory (kStride = n / N; the same address in
// every lane, one broadcast), then radix-B butterflies over x[b + B a] for
// each a. Register r ends holding X[lane_out<N>(r)].
template <int N>
struct LaneSplit {
  static constexpr int A = N == 16 ? 4 : 8;
  static constexpr int B = N / A;
  static_assert(N == 8 || N == 16 || N == 32, "lane line length");
};

template <int N>
__host__ __device__ constexpr int lane_out(int r) {
  return r / LaneSplit<N>::B + LaneSplit<N>::A * (r % LaneSplit<N>::B);
}

template <int N, int kStride>
__device__ __forceinline__ void lane_fft(float2 (&x)[N], const float2* table,
                                         bool inv) {
  constexpr int A = LaneSplit<N>::A, B = LaneSplit<N>::B;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float2 t[A];
#pragma unroll
    for (int a = 0; a < A; ++a) t[a] = x[b + B * a];
    butterfly<A>(t, inv);
#pragma unroll
    for (int a = 0; a < A; ++a)
      x[b + B * a] =
          a * b == 0 ? t[a] : cmul(t[a], table[pad(a * b * kStride)]);
  }
  if constexpr (B > 1) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float2 t[B];
#pragma unroll
      for (int b = 0; b < B; ++b) t[b] = x[b + B * a];
      butterfly<B>(t, inv);
#pragma unroll
      for (int b = 0; b < B; ++b) x[b + B * a] = t[b];
    }
  }
}

// A 64-long line on two lanes of a warp, t and t ^ 16 (p = bit 4 of the
// lane): lane p holds x[p + 2 i] in register i < 32 and transforms its
// half (lane_fft<32>: F_p[k]); the pair swaps sixteen values by
// __shfl_xor_sync, so that lane p holds F_0[k] and F_1[k] for the k of
// its registers 16 p .. 16 p + 15, multiplies F_1[k] by w_64^k (the table
// at pad(k kStride), kStride = n / 64) and forms X[k] = F_0 + w F_1 in
// register i and X[k + 32] = F_0 - w F_1 in register 16 + i. Register r
// ends holding X[pair_out(p, r)].
__host__ __device__ constexpr int pair_out(int p, int r) {
  return lane_out<32>(r % 16 + 16 * p) + 32 * (r / 16);
}

template <int kStride>
__device__ __forceinline__ void pair_fft(float2 (&v)[32], int p,
                                         const float2* table, bool inv) {
  lane_fft<32, 2 * kStride>(v, table, inv);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 send = p ? v[i] : v[16 + i];
    float2 got;
    got.x = __shfl_xor_sync(0xffffffffu, send.x, 16);
    got.y = __shfl_xor_sync(0xffffffffu, send.y, 16);
    const float2 a = p ? got : v[i];
    const float2 b = cmul(p ? v[16 + i] : got,
                          table[pad((p ? lane_out<32>(16 + i)
                                       : lane_out<32>(i)) * kStride)]);
    v[i] = cadd(a, b);
    v[16 + i] = csub(a, b);
  }
}

// The geometry at n = N1 N2 (N1, N2 in 8..64, N2 >= 16): a team of
// kTeamWarps warps holds 32 values a lane, R = 1024 kTeamWarps / n rows;
// a line of 8 to 32 lies in one lane (32 / N of them a lane), a line of 64
// on a lane pair (pair_fft). The tile holds element (k1, j2) of the
// (N1, N2) view of the team's row r at r n + k1 N2 + (j2 ^ ((k1 + N1 r)
// mod 16)): half a warp writes sixteen consecutive columns j2 of one k1 in
// pass 1 and reads one j2 of sixteen consecutive lines k1 + N1 r in pass
// 2, and both hit sixteen bank pairs.
template <int kN1, int kN2, int kTeamWarps, int kThreads>
struct LaneStep {
  static constexpr int N1 = kN1, N2 = kN2, n = kN1 * kN2;
  static constexpr int lanes = 32 * kTeamWarps;          // of a team
  static constexpr int rows = 1024 * kTeamWarps / n;     // a team holds
  static constexpr bool pair1 = N1 == 64, pair2 = N2 == 64;
  static constexpr int L1 = pair1 ? 1 : 32 / N1;         // lines a lane
  static constexpr int L2 = pair2 ? 1 : 32 / N2;         // holds
  static constexpr int teams = kThreads / lanes;
  static constexpr int table = n + n / 16;               // pad(n) float2
  static constexpr size_t smem = (size_t)(table + teams * rows * n) * 8;
  static_assert(N1 >= 8 && N2 >= 16 && N2 <= 64 && rows >= 1 &&
                    rows * n == 1024 * kTeamWarps,
                "lane split: 32 values a lane");
  static_assert(teams * lanes == kThreads && teams <= 15, "teams");
};

// The index in its line of register r of a transformed line of N: in one
// lane, or on a pair (N = 64) at place p.
template <int N>
__device__ __forceinline__ int line_out(int p, int r) {
  if constexpr (N == 64)
    return pair_out(p, r);
  else
    return lane_out<N>(r);
}

// Line s of team lane t in a pass (a line on a pair: both lanes' line).
template <bool kPair, int kLanes>
__device__ __forceinline__ int lane_line(int t, int s) {
  return kPair ? (t & 15) + 16 * (t >> 5) : t + kLanes * s;
}

// Blocks of the lane kernel an SM must hold: five of 128 threads (at most
// 102 registers; the compiler takes 92-96 at n = 128 to 2048, with no
// spill), two of 256 (n = 4096: 128). On the H100, five beat four at n =
// 2048 and tied at 1024 (PERF.md); no bound (up to 240 registers) lost.
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

// 128 <= n <= 4096: block b stages the table, then takes row groups b, b +
// gridDim.x, ...; team e of a group transforms rows [(group teams + e) R,
// + R). Pass 1: the lines are the columns j2 of the (N1, N2) view, lane t
// holding lines t + 32 W s (row line / N2, j2 = line mod N2) with register
// j1 holding x[N2 j1 + j2], or for N1 = 64 line (t mod 16) + 16 (t / 32)
// on a pair with register i holding x[N2 (p + 2 i) + j2]: a warp's load
// instruction reads 32 consecutive elements (16 in each of two view rows
// for a pair). Pass 2: the lines are the rows k1 (row line / N1, k1 =
// line mod N1) in the same arrangement, register j2 (or p + 2 i) holding
// Y'[k1, j2], stored at X[k1 + N1 k2]: 32 (or 2 x 16) consecutive elements
// a store instruction. Rows past the batch compute on zeros and store
// nothing. The body of minor_lane_kernel (K1, K20) and
// minor_lane_padded_kernel (K9: input rows of n_in, so pass 1's register
// j1 of column j2 is 0 for N2 j1 + j2 >= n_in; n_in = n otherwise).
template <typename T, int N1, int N2, int kTeamWarps, int kThreads,
          bool kFused, bool kPadded>
__device__ __forceinline__ void lane_rows(
    const T* __restrict__ xr, const T* __restrict__ xi, T* __restrict__ yr,
    T* __restrict__ yi, const float2* __restrict__ tw, int64_t batch,
    int n_in, int inverse, float scale) {
  using S = LaneStep<N1, N2, kTeamWarps, kThreads>;
  constexpr int n = S::n, R = S::rows;
  extern __shared__ float2 tpufft_lane_smem[];
  float2* table = tpufft_lane_smem;
  const int team = threadIdx.x / S::lanes;
  const int t = threadIdx.x - team * S::lanes;
  const int p = (t >> 4) & 1;  // place in a lane pair
  float2* tile = table + S::table + team * R * n;
  const bool inv = inverse != 0;
  for (int i = threadIdx.x; i < n; i += kThreads) table[pad(i)] = __ldg(&tw[i]);
  __syncthreads();
  const int64_t groups = (batch + S::teams * R - 1) / (S::teams * R);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * S::teams + team) * R;
    {  // pass 1: the columns, from device memory into the tile
      constexpr int V = S::pair1 ? 32 : N1;
      float2 v[S::L1][V];
#pragma unroll
      for (int s = 0; s < S::L1; ++s) {
        const int line = lane_line<S::pair1, S::lanes>(t, s);
        const int64_t row = row0 + line / N2;
        const int j2 = line % N2;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int j1 = S::pair1 ? p + 2 * j : j;
          v[s][j] = row < batch ? row_load<T, kFused, kPadded>(
                                      xr, xi, row, n, n_in, N2 * j1 + j2)
                                : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int s = 0; s < S::L1; ++s) {
        if constexpr (S::pair1)
          pair_fft<n / 64>(v[s], p, table, inv);
        else
          lane_fft<N1, n / N1>(v[s], table, inv);
      }
#pragma unroll
      for (int s = 0; s < S::L1; ++s) {
        const int line = lane_line<S::pair1, S::lanes>(t, s);
        const int r = line / N2, j2 = line % N2;
        float2* dst = tile + r * n;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int k1 = line_out<N1>(p, q);
          dst[k1 * N2 + (j2 ^ ((k1 + N1 * r) & 15))] =
              cmul(v[s][q], table[pad(k1 * j2)]);
        }
      }
    }
    team_sync<kTeamWarps>(team);
    {  // pass 2: the rows k1 of the tile, stored to device memory
      constexpr int V = S::pair2 ? 32 : N2;
      float2 v[S::L2][V];
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        const int line = lane_line<S::pair2, S::lanes>(t, s);
        const float2* src = tile + (line / N1) * n + (line % N1) * N2;
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[s][j] = src[(S::pair2 ? p + 2 * j : j) ^ (line & 15)];
      }
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        if constexpr (S::pair2)
          pair_fft<n / 64>(v[s], p, table, inv);
        else
          lane_fft<N2, n / N2>(v[s], table, inv);
      }
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        const int line = lane_line<S::pair2, S::lanes>(t, s);
        const int64_t row = row0 + line / N1;
        const int k1 = line % N1;
        if (row < batch) {
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const int k2 = line_out<N2>(p, q);
            line_store<T, kFused>(yr, yi, row, n, k1 + N1 * k2, v[s][q],
                                  scale);
          }
        }
      }
    }
    team_sync<kTeamWarps>(team);  // the tile is read before it is rewritten
  }
}

template <typename T, int N1, int N2, int kTeamWarps, int kThreads,
          bool kFused>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks(kThreads))
minor_lane_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ yr, T* __restrict__ yi,
                  const float2* __restrict__ tw, int64_t batch, int inverse,
                  float scale) {
  lane_rows<T, N1, N2, kTeamWarps, kThreads, kFused, false>(
      xr, xi, yr, yi, tw, batch, N1 * N2, inverse, scale);
}

// K9 at 128 <= n <= 4096: (batch, n_in) rows, 1 <= n_in < n, zero-padded
// to n = N1 N2.
template <typename T, int N1, int N2, int kTeamWarps, int kThreads>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks(kThreads))
minor_lane_padded_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                         T* __restrict__ yr, T* __restrict__ yi,
                         const float2* __restrict__ tw, int64_t batch,
                         int n_in, int inverse, float scale) {
  lane_rows<T, N1, N2, kTeamWarps, kThreads, false, true>(
      xr, xi, yr, yi, tw, batch, n_in, inverse, scale);
}

}  // namespace tpufft_minor
