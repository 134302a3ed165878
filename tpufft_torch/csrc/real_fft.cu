// Batched real-input FFT (rfft) and its inverse (irfft) along the contiguous
// minor axis, with plain C entry points for ctypes
// (tpufft_torch/kernels/real_fft.py binds and checks them).
//
// Replaces two Pallas TPU kernels of tpufft/kernels/mxu_fft.py:
//   K7 _build_minor_r2c: real (batch, n) -> (batch, n//2+1) re/im planes;
//   K8 _build_minor_c2r: (batch, n//2+1) re/im planes -> real (batch, n),
//      the imaginary parts of the DC and (even n) Nyquist bins ignored.
// Contract as there: f32 or bf16 storage, f32 arithmetic, the scale applied
// once at the store; any n the length envelope admits, odd and prime
// included. K7 is always the forward transform and K8 the inverse.
//
// What bounds them on an H100: device-memory bandwidth, as for K1
// (minor_fft.cuh). The TPU kernels are dense (n, n//2+1) matmuls, which
// suit the MXU and made rfft cost twice its C2C there; here each kernel is
// one pass of the shared-memory Stockham (fft_stages.cuh) with a packing
// step around it, so it moves fewer bytes than K1 at the same n:
//
// - even n = 2m (m in K1's envelope, so n <= 32768): rfft reads the real
//   row as m complex values z[j] = x[2j] + i x[2j+1] (one 8-byte load per
//   pair, no zero plane read), runs the length-m stages, and untangles
//   X[k] = (Z[k] + conj Z[m-k]) / 2 - i W^k (Z[k] - conj Z[m-k]) / 2,
//   k = 0..m, Z[m] = Z[0], W^k = exp(-2 pi i k / n) from a host f64 table,
//   while storing. irfft forms Z'[k] = (X[k] + conj X[m-k])
//   + i conj(W^k) (X[k] - conj X[m-k]) for k < m in shared memory, runs the
//   inverse length-m stages, and stores z'[j] as the pair (x[2j], x[2j+1]);
//   Z' = 2Z, which is the factor 2 of tpufft's packed inverse folded in;
// - odd n (in K1's envelope): rfft loads the row with a zero imaginary part
//   and stores the first n//2+1 bins of the length-n transform; irfft
//   extends the half spectrum Hermitian-wise in registers at the load
//   (X[n-k] = conj X[k]) and stores the real part.
//
// Both kernels have two forms; the host picks one by n (tpufft_rfft,
// tpufft_irfft; kernels/real_fft.py:form mirrors the choice,
// tpufft_real_line_geometry reports it). The line form has two
// templates:
// - at a power-of-two half, the kernels below (rfft_lane_kernel,
//   irfft_lane_kernel);
// - at a half m on K1's mixed-radix family lists (n = 24 to 7680: 3, 5
//   and 15 times a power of two, 186, 2000, 2160, 4320) and at odd n = 93,
//   K1's own four-step body (minor_fft.cuh: lane_steps) with the real
//   kernels' loads and hand-overs (real_fft.cuh: rfft_mixed_kernel,
//   irfft_mixed_kernel, rfft_odd_kernel, irfft_odd_kernel; instantiated by
//   real_line_{r3,r5,r15,odd}.cu): packed rows untangled or tangled
//   through the tile in natural order, or the length-n four-step of the
//   real row (K7: the bins up to n/2 stored; K8: the Hermitian extension
//   gathered in its load).
//
// K7's line form (rfft_lane_kernel), for even n = 2m with m a power of two
// from 128 to 4096 (n = 256 to 8192): the packed row runs K1's line form
// at length m (minor_fft.cuh: LaneStep; lane_dft.cuh: lane_dft and
// pair_dft; the staged w_m table, blocks looping over row groups), its
// load reading each pair
// x[2j], x[2j+1] as one 8-byte (bf16: 4-byte) value, so that a warp's load
// instruction reads 256 consecutive bytes. Pass 2 leaves Z[k1 + N1 k2] in
// registers; bins k and m - k lie in other lanes then (line N1 - k1, k2
// mirrored; line 0 pairs with itself), so the team writes Z back into its
// tile in natural order, at r m + (k ^ ((N1 r) mod 16)), and after one
// team barrier each lane reads the pairs Z[k], Z[m-k] of 16 bins k < m/2,
// consecutive lanes on consecutive k, and stores both bins of each pair:
//   X[k] = (s - u) / 2, X[m-k] = conj(s + u) / 2,
//   s = Z[k] + conj Z[m-k], u = i W^k (Z[k] - conj Z[m-k]),
// with W^k from half_tw (read through the read-only cache) and, in the
// lane of k = 0, X[m/2] = conj Z[m/2]. A warp's store instruction writes
// 32 consecutive bins of each plane (ascending for k, descending for
// m - k); rows of m + 1 bins start unaligned, so every store is a 4-byte
// (2-byte) access. The XOR keeps pass 2's writes (two rows a half warp at
// N1 = 8) and the untangle's reads free of bank conflicts
// (tests/test_torch_kernel_real.py models both).
//
// K8's line form (irfft_lane_kernel), at the same n: the inverse-real line
// core of real_fft.cuh on the same geometry. Lanes on consecutive bins k <
// m/2 read X[k] and X[m - k] of each plane (an ascending and a descending
// run, 4-byte loads: rows of m + 1 bins start unaligned), tangle them into
// Z'[k] and Z'[m - k] in the team's tile, and after one team barrier the
// inverse four-step runs at m with pass 1 reading the tile; pass 2 leaves
// z'[j] = (y[2j], y[2j+1]) in registers, lanes on consecutive j, and each
// pair is stored as one 8-byte (bf16: 4-byte) value, so that a warp's
// store instruction writes 256 consecutive bytes. What bounds it on the
// H100 is what bounds K7's line form, the bytes: its stores are whole
// aligned lines, and its reads are the unaligned 4-byte runs that K7's
// stores are.
//
// The stage form (rfft_kernel, irfft_kernel), for every other length (odd
// n but 93, halves on no list such as 500, halves above 4096, n <= 128 at
// power-of-two halves; tpufft_rfft_stages and tpufft_irfft_stages run it
// at every length):
// rows are packed to blocks exactly as K1's stage form packs them
// (launch_geometry of the stage length), and the same launch bounds hold
// registers to 64.

#include <climits>

#include "real_fft.cuh"

using namespace tpufft_fft;
using tpufft_minor::Geometry;
using tpufft_minor::kLaneMinBlocks;
using tpufft_lane::lane_dft;
using tpufft_minor::lane_line;
using tpufft_minor::LaneStep;
using tpufft_minor::launch_geometry;
using tpufft_minor::line_out;
using tpufft_lane::pair_dft;
using tpufft_minor::team_sync;
using tpufft_real::launch_lane;
using tpufft_real::load_pair;
using tpufft_real::store_pair;

namespace {

// K7. Block b transforms rows [b*rows, b*rows + rows) of the real (batch, n)
// plane x into the (batch, n//2+1) planes yr/yi. kPacked: n = 2 plan.n,
// stages of length m = plan.n on z[j] = x[2j] + i x[2j+1], half_tw[k] =
// exp(-2 pi i k / n) for k <= m. Otherwise n = plan.n.
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rfft_kernel(const T* __restrict__ x, T* __restrict__ yr, T* __restrict__ yi,
            const float2* __restrict__ tw,
            const float2* __restrict__ half_tw, int64_t batch, Radices plan,
            int rows, float scale) {
  extern __shared__ float2 tpufft_rfft_smem[];
  float2* buf = tpufft_rfft_smem;
  const int L = plan.n;  // stage length
  const int n = kPacked ? 2 * L : L;
  const int m1 = n / 2 + 1;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int here = (int)(batch - row0 < rows ? batch - row0 : rows);
  const int total = rows * L;
  const int valid = here * L;
  const int64_t in0 = row0 * n;
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.f, 0.f);
    if (e < valid)
      v[k] = kPacked ? load_pair(x, in0 + 2 * (int64_t)e)
                     : make_float2(load_f(x, in0 + e), 0.f);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) buf[pad(e)] = v[k];
  }
  __syncthreads();
  run_stages<kPer>(buf, tw, plan, rows, false);
  const int64_t out0 = row0 * m1;
  const int outs = here * m1;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int r = e / m1, k = e - r * m1;
    float2 X;
    if (kPacked) {
      X = tpufft_real::untangle(buf, r * L, L, k, half_tw);
    } else {
      X = buf[pad(r * L + k)];
    }
    store_f(yr, out0 + e, X.x * scale);
    store_f(yi, out0 + e, X.y * scale);
  }
}

// K7's line form at n = 2m, m = N1 N2 (the header's first form): block b
// stages the w_m table, then takes row groups b, b + gridDim.x, ...; team
// e of a group transforms rows [(group teams + e) R, + R). Passes 1 and 2
// are minor_lane_kernel's at length m on z[j] = x[2j] + i x[2j+1]; then
// the untangle through the tile. Rows past the batch compute on zeros and
// store nothing.
template <typename T, int N1, int N2, int kTeamWarps, int kThreads>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks(kThreads))
rfft_lane_kernel(const T* __restrict__ x, T* __restrict__ yr,
                 T* __restrict__ yi, const float2* __restrict__ tw,
                 const float2* __restrict__ half_tw, int64_t batch,
                 float scale) {
  using S = LaneStep<N1, N2, kTeamWarps, kThreads>;
  constexpr int m = S::n, n = 2 * m, R = S::rows, H = m / 2;
  extern __shared__ float2 tpufft_rfft_lane_smem[];
  float2* table = tpufft_rfft_lane_smem;
  const int team = threadIdx.x / S::lanes;
  const int t = threadIdx.x - team * S::lanes;
  const int p = (t >> 4) & 1;  // place in a lane pair
  float2* tile = table + S::table + team * R * m;
  const float hs = 0.5f * scale;  // the untangle's 1/2, scaled
  for (int i = threadIdx.x; i < m; i += kThreads) table[pad(i)] = __ldg(&tw[i]);
  __syncthreads();
  const int64_t groups = (batch + S::teams * R - 1) / (S::teams * R);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * S::teams + team) * R;
    {  // pass 1: the columns of the packed rows, into the tile
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
          v[s][j] = row < batch ? load_pair(x, row * n + 2 * (N2 * j1 + j2))
                                : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int s = 0; s < S::L1; ++s) {
        if constexpr (S::pair1)
          pair_dft<32, m / 64>(v[s], p, table, false);
        else
          lane_dft<N1, m / N1, 0, 1>(v[s], table, false);
      }
#pragma unroll
      for (int s = 0; s < S::L1; ++s) {
        const int line = lane_line<S::pair1, S::lanes>(t, s);
        const int r = line / N2, j2 = line % N2;
        float2* dst = tile + r * m;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int k1 = line_out<N1>(p, q);
          dst[k1 * N2 + (j2 ^ ((k1 + N1 * r) & 15))] =
              cmul(v[s][q], table[pad(k1 * j2)]);
        }
      }
    }
    team_sync<kTeamWarps>(team);
    {  // pass 2: the rows k1 of the tile, Z back into it in natural order
      constexpr int V = S::pair2 ? 32 : N2;
      float2 v[S::L2][V];
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        const int line = lane_line<S::pair2, S::lanes>(t, s);
        const float2* src = tile + (line / N1) * m + (line % N1) * N2;
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[s][j] = src[(S::pair2 ? p + 2 * j : j) ^ (line & 15)];
      }
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        if constexpr (S::pair2)
          pair_dft<32, m / 64>(v[s], p, table, false);
        else
          lane_dft<N2, m / N2, 0, 1>(v[s], table, false);
      }
      team_sync<kTeamWarps>(team);  // every line is read before Z lands
#pragma unroll
      for (int s = 0; s < S::L2; ++s) {
        const int line = lane_line<S::pair2, S::lanes>(t, s);
        const int r = line / N1, k1 = line % N1;
        float2* dst = tile + r * m;
#pragma unroll
        for (int q = 0; q < V; ++q)
          dst[(k1 + N1 * line_out<N2>(p, q)) ^ ((N1 * r) & 15)] = v[s][q];
      }
    }
    team_sync<kTeamWarps>(team);
    // the untangle: lane t takes the pairs (k, m - k) of e = t + lanes i.
    // Unrolled whole for teams of one or two warps, by 4 for the four-warp
    // teams of n = 8192: the faster at each n on the H100 (PERF.md,
    // tools/rfft_phases.py)
    constexpr int kUnroll = kTeamWarps <= 2 ? R * H / S::lanes : 4;
#pragma unroll (kUnroll)
    for (int i = 0; i < R * H / S::lanes; ++i) {
      const int e = t + S::lanes * i;
      const int r = e / H, k = e % H, sw = (N1 * r) & 15;
      const float2* z = tile + r * m;
      const float2 a = z[k ^ sw];                  // Z[k]
      const float2 b = z[((m - k) & (m - 1)) ^ sw];  // Z[m-k], Z[0] at k = 0
      const float2 s = make_float2(a.x + b.x, a.y - b.y);
      const float2 wd = cmul(__ldg(&half_tw[k]),
                             make_float2(a.x - b.x, a.y + b.y));
      const int64_t row = row0 + r;
      if (row < batch) {
        const int64_t out = row * (m + 1);
        store_f(yr, out + k, hs * (s.x + wd.y));
        store_f(yi, out + k, hs * (s.y - wd.x));
        store_f(yr, out + m - k, hs * (s.x - wd.y));
        store_f(yi, out + m - k, -hs * (s.y + wd.x));
        if (k == 0) {
          const float2 c = z[H ^ sw];  // X[m/2] = conj Z[m/2]
          store_f(yr, out + H, c.x * scale);
          store_f(yi, out + H, -c.y * scale);
        }
      }
    }
    team_sync<kTeamWarps>(team);  // the tile is read before it is rewritten
  }
}

// K8. Block b synthesizes rows [b*rows, b*rows + rows) of the real
// (batch, n) plane y from the (batch, n//2+1) planes xr/xi. kPacked and
// half_tw as for rfft_kernel. The packed form keeps each row's Nyquist bin
// in `rows` extra float2 after the stage buffer.
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
irfft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
             T* __restrict__ y, const float2* __restrict__ tw,
             const float2* __restrict__ half_tw, int64_t batch, Radices plan,
             int rows, float scale) {
  extern __shared__ float2 tpufft_irfft_smem[];
  float2* buf = tpufft_irfft_smem;
  const int L = plan.n;  // stage length
  const int n = kPacked ? 2 * L : L;
  const int m1 = n / 2 + 1;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int here = (int)(batch - row0 < rows ? batch - row0 : rows);
  const int total = rows * L;
  const int valid = here * L;
  const int64_t in0 = row0 * m1;
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.f, 0.f);
    if (e < valid) {
      const int r = e / L, j = e - r * L;
      // packed: X[j], j < m; odd: X[j] or conj X[n-j] for j > n/2
      const int src = (kPacked || j < m1) ? j : n - j;
      const int64_t at = in0 + (int64_t)r * m1 + src;
      const float im = src == 0 ? 0.f : load_f(xi, at);
      v[k] = make_float2(load_f(xr, at), src == j ? im : -im);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) buf[pad(e)] = v[k];
  }
  if (kPacked) {
    float2* nyq = buf + pad(total);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      nyq[r] = make_float2(
          r < here ? load_f(xr, in0 + (int64_t)r * m1 + L) : 0.f, 0.f);
    __syncthreads();
    // Z'[j] = (X[j] + conj X[m-j]) + i conj(W^j) (X[j] - conj X[m-j])
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < total) {
        const int r = e / L, j = e - r * L;
        const float2 a = v[k];
        const float2 b = j == 0 ? nyq[r] : buf[pad(r * L + L - j)];
        const float2 w = __ldg(&half_tw[j]);
        const float2 wd = cmul(make_float2(w.x, -w.y),
                               make_float2(a.x - b.x, a.y + b.y));
        v[k] = make_float2(a.x + b.x - wd.y, a.y - b.y + wd.x);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < total) buf[pad(e)] = v[k];
    }
  }
  __syncthreads();
  run_stages<kPer>(buf, tw, plan, rows, true);
  const int64_t out0 = row0 * n;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < valid) {
      const float2 z = buf[pad(e)];
      if (kPacked)
        store_pair(y, out0 + 2 * (int64_t)e,
                   make_float2(z.x * scale, z.y * scale));
      else
        store_f(y, out0 + e, z.x * scale);
    }
  }
}

// K8's line form at n = 2m, m = N1 N2 (the header's K8 line form): block b
// stages the inverse w_m table, then takes row groups b, b + gridDim.x, ...;
// team e of a group synthesizes rows [(group teams + e) R, + R) through the
// inverse-real line core (real_fft.cuh: the tangle of the bins into the
// tile, K1's inverse four-step at m), and each lane stores its pairs z'[j]
// times scale as (y[2j], y[2j+1]), one 8-byte (bf16: 4-byte) store each.
// Rows past the batch compute on zeros and store nothing.
//
// Blocks an SM: four of 128 threads (up to 128 registers) where N1 = 32 (n
// = 1024 to 4096), whose core spills 32-36 bytes under five blocks' bound
// and ran 9-12 % slower there on the H100 (tools/inverse_phases.py,
// PERF.md); elsewhere K7's (five of 128 threads, two of 256).
__host__ __device__ constexpr int kIrfftMinBlocks(int n1, int threads) {
  return threads == 128 && n1 == 32 ? 4 : kLaneMinBlocks(threads);
}

template <typename T, int N1, int N2, int kTeamWarps, int kThreads>
__global__ void __launch_bounds__(kThreads, kIrfftMinBlocks(N1, kThreads))
irfft_lane_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ y, const float2* __restrict__ tw,
                  const float2* __restrict__ half_tw, int64_t batch,
                  float scale) {
  using S = LaneStep<N1, N2, kTeamWarps, kThreads>;
  constexpr int m = S::n, R = S::rows;
  extern __shared__ float2 tpufft_irfft_lane_smem[];
  float2* table = tpufft_irfft_lane_smem;
  const int team = threadIdx.x / S::lanes;
  const int t = threadIdx.x - team * S::lanes;
  float2* tile = table + S::table + team * R * m;
  for (int i = threadIdx.x; i < m; i += kThreads) table[pad(i)] = __ldg(&tw[i]);
  __syncthreads();
  const int64_t groups = (batch + S::teams * R - 1) / (S::teams * R);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * S::teams + team) * R;
    tpufft_real::tangle<S>(tile, t, half_tw, [&](int r, int k) {
      const int64_t row = row0 + r;
      if (row >= batch) return make_float2(0.f, 0.f);
      const int64_t at = row * (m + 1) + k;
      return make_float2(load_f(xr, at), load_f(xi, at));
    });
    typename tpufft_real::LineCore<S>::Out v;
    tpufft_real::inverse_passes<S>(tile, table, team, t, v);
    tpufft_real::for_each_pair<S>(t, v, [&](int r, int j, float2 z) {
      const int64_t row = row0 + r;
      if (row < batch)
        store_pair(y, row * (2 * m) + 2 * j,
                   make_float2(z.x * scale, z.y * scale));
    });
    team_sync<kTeamWarps>(team);  // the tile is read before it is rewritten
  }
}

// Dynamic shared memory of a block: the stage buffer, plus the Nyquist
// bins of the packed irfft.
inline size_t smem_bytes(const Geometry& g, bool nyquist) {
  return g.smem + (nyquist ? (size_t)g.rows * sizeof(float2) : 0);
}

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPacked>
int launch_r2c(const void* x, void* yr, void* yi, const void* tw,
               const void* half_tw, long long batch, const Radices& plan,
               const Geometry& g, float scale, cudaStream_t stream) {
  auto* kernel = rfft_kernel<T, kThreads, kPer, kMinBlocks, kPacked>;
  if (g.threads > kThreads || g.per != kPer) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g, false);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + g.rows - 1) / g.rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, g.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(yr), static_cast<T*>(yi),
      static_cast<const float2*>(tw), static_cast<const float2*>(half_tw),
      (int64_t)batch, plan, g.rows, scale);
  return (int)cudaGetLastError();
}

// Is the real length n one of K7's line form (even, n/2 a power of two from
// 128 to 4096)?
inline bool r2c_line_form(int n) {
  const int m = n / 2;
  return n % 2 == 0 && m >= 128 && m <= tpufft_minor::kLineMaxN &&
         (m & (m - 1)) == 0;
}

// The line form at n = 2m, on tpufft_real::with_line_step's geometry.
template <typename T>
int launch_r2c_lines(const void* x, void* yr, void* yi, const void* tw,
                     const void* half_tw, long long batch, int n, float scale,
                     cudaStream_t stream) {
  return tpufft_real::with_line_step(n, [&](auto step) {
    using S = decltype(step);
    return launch_lane<S>(
        rfft_lane_kernel<T, S::N1, S::N2, S::lanes / 32, S::teams * S::lanes>,
        batch, stream, static_cast<const T*>(x), static_cast<T*>(yr),
        static_cast<T*>(yi), static_cast<const float2*>(tw),
        static_cast<const float2*>(half_tw), (int64_t)batch, scale);
  });
}

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPacked>
int launch_c2r(const void* xr, const void* xi, void* y, const void* tw,
               const void* half_tw, long long batch, const Radices& plan,
               const Geometry& g, float scale, cudaStream_t stream) {
  auto* kernel = irfft_kernel<T, kThreads, kPer, kMinBlocks, kPacked>;
  if (g.threads > kThreads || g.per != kPer) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g, kPacked);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + g.rows - 1) / g.rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, g.threads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(y), static_cast<const float2*>(tw),
      static_cast<const float2*>(half_tw), (int64_t)batch, plan, g.rows,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kPacked>
int launch_r2c_sized(const void* x, void* yr, void* yi, const void* tw,
                     const void* half_tw, long long batch,
                     const Radices& plan, float scale, bool lines,
                     cudaStream_t stream) {
  if constexpr (kPacked) {
    if (lines && r2c_line_form(2 * plan.n))
      return launch_r2c_lines<T>(x, yr, yi, tw, half_tw, batch, 2 * plan.n,
                                 scale, stream);
  }
  const int n = kPacked ? 2 * plan.n : plan.n;
  if (lines && tpufft_real::real_family(n) != 0) {
    const tpufft_real::RealArgs a{x,  nullptr, yr,    yi,    tw,
                                  half_tw, batch, scale, stream};
    return tpufft_real::launch_real_mixed<T>(a, n, false);
  }
  const Geometry g = launch_geometry(plan.n);
  if (g.per == 8)
    return launch_r2c<T, 512, 8, 2, kPacked>(x, yr, yi, tw, half_tw, batch,
                                             plan, g, scale, stream);
  return launch_r2c<T, 1024, 16, 1, kPacked>(x, yr, yi, tw, half_tw, batch,
                                             plan, g, scale, stream);
}

// K8's line form at n = 2m, on K7's geometry.
template <typename T>
int launch_c2r_lines(const void* xr, const void* xi, void* y, const void* tw,
                     const void* half_tw, long long batch, int n, float scale,
                     cudaStream_t stream) {
  return tpufft_real::with_line_step(n, [&](auto step) {
    using S = decltype(step);
    return launch_lane<S>(
        irfft_lane_kernel<T, S::N1, S::N2, S::lanes / 32, S::teams * S::lanes>,
        batch, stream, static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<T*>(y), static_cast<const float2*>(tw),
        static_cast<const float2*>(half_tw), (int64_t)batch, scale);
  });
}

// K8 of the form the host picks (lines: r2c_line_form's lengths and the
// mixed-radix ones of real_family), or the stage form at any length (lines
// false). launch_r2c_sized likewise for K7.
template <typename T, bool kPacked>
int launch_c2r_sized(const void* xr, const void* xi, void* y, const void* tw,
                     const void* half_tw, long long batch,
                     const Radices& plan, float scale, bool lines,
                     cudaStream_t stream) {
  if constexpr (kPacked) {
    if (lines && r2c_line_form(2 * plan.n))
      return launch_c2r_lines<T>(xr, xi, y, tw, half_tw, batch, 2 * plan.n,
                                 scale, stream);
  }
  const int n = kPacked ? 2 * plan.n : plan.n;
  if (lines && tpufft_real::real_family(n) != 0) {
    const tpufft_real::RealArgs a{xr, xi,    y,     nullptr, tw,
                                  half_tw, batch, scale, stream};
    return tpufft_real::launch_real_mixed<T>(a, n, true);
  }
  const Geometry g = launch_geometry(plan.n);
  if (g.per == 8)
    return launch_c2r<T, 512, 8, 2, kPacked>(xr, xi, y, tw, half_tw, batch,
                                             plan, g, scale, stream);
  return launch_c2r<T, 1024, 16, 1, kPacked>(xr, xi, y, tw, half_tw, batch,
                                             plan, g, scale, stream);
}

// The stage plan of length n: m = n/2 for even n, n for odd n.
bool real_plan(int n, const int* radices, int nstages, Radices* plan) {
  if (n < 2) return false;
  return make_radices(n % 2 == 0 ? n / 2 : n, radices, nstages, plan);
}

}  // namespace

namespace {

int rfft_entry(const void* x, void* yr, void* yi, const void* tw,
               const void* half_tw, long long batch, int n,
               const int* radices, int nstages, float scale, int bf16,
               bool lines, void* stream) {
  Radices plan;
  if (batch < 0 || !real_plan(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool even = n % 2 == 0;
  if (bf16)
    return even ? launch_r2c_sized<__nv_bfloat16, true>(
                      x, yr, yi, tw, half_tw, batch, plan, scale, lines, s)
                : launch_r2c_sized<__nv_bfloat16, false>(
                      x, yr, yi, tw, half_tw, batch, plan, scale, lines, s);
  return even ? launch_r2c_sized<float, true>(x, yr, yi, tw, half_tw, batch,
                                              plan, scale, lines, s)
              : launch_r2c_sized<float, false>(x, yr, yi, tw, half_tw, batch,
                                               plan, scale, lines, s);
}

}  // namespace

// rfft of the real (batch, n) plane x into the (batch, n//2+1) planes yr/yi
// (f32, or bf16 when bf16 != 0), times scale, on `stream`, a stream of the
// current device. With L = n/2 for even n and L = n for odd n: tw holds the
// L complex f32 values exp(-2 pi i k / L), radices[0:nstages] multiply to L
// (each 2, 4, 8 or an odd value up to 127; the line form, which the
// lengths of tpufft_real_line_geometry run, ignores them), and half_tw,
// read for even n only, holds exp(-2 pi i k / n) for k = 0..n/2. For even
// n, x must be 8-byte (f32) or 4-byte (bf16) aligned. Returns 0 or the CUDA
// error code.
extern "C" int tpufft_rfft(const void* x, void* yr, void* yi, const void* tw,
                           const void* half_tw, long long batch, int n,
                           const int* radices, int nstages, float scale,
                           int bf16, void* stream) {
  return rfft_entry(x, yr, yi, tw, half_tw, batch, n, radices, nstages,
                    scale, bf16, true, stream);
}

// tpufft_rfft on the stage form at every length: the form that the line
// form's lengths ran before it, kept for comparison (chip_smoke.py times
// both).
extern "C" int tpufft_rfft_stages(const void* x, void* yr, void* yi,
                                  const void* tw, const void* half_tw,
                                  long long batch, int n, const int* radices,
                                  int nstages, float scale, int bf16,
                                  void* stream) {
  return rfft_entry(x, yr, yi, tw, half_tw, batch, n, radices, nstages,
                    scale, bf16, false, stream);
}

namespace {

int irfft_entry(const void* xr, const void* xi, void* y, const void* tw,
                const void* half_tw, long long batch, int n,
                const int* radices, int nstages, float scale, int bf16,
                bool lines, void* stream) {
  Radices plan;
  if (batch < 0 || !real_plan(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool even = n % 2 == 0;
  if (bf16)
    return even ? launch_c2r_sized<__nv_bfloat16, true>(
                      xr, xi, y, tw, half_tw, batch, plan, scale, lines, s)
                : launch_c2r_sized<__nv_bfloat16, false>(
                      xr, xi, y, tw, half_tw, batch, plan, scale, lines, s);
  return even ? launch_c2r_sized<float, true>(xr, xi, y, tw, half_tw, batch,
                                              plan, scale, lines, s)
              : launch_c2r_sized<float, false>(xr, xi, y, tw, half_tw, batch,
                                               plan, scale, lines, s);
}

}  // namespace

// irfft of the (batch, n//2+1) planes xr/xi into the real (batch, n) plane
// y, times scale (scale 1/n is numpy's irfft), on `stream`. tw holds
// exp(+2 pi i k / L), the inverse table; radices and half_tw as for
// tpufft_rfft (the line form, which the lengths of
// tpufft_real_line_geometry run, ignores the radices). For even n, y must
// be 8-byte (f32) or 4-byte (bf16) aligned. Returns 0 or the CUDA error
// code.
extern "C" int tpufft_irfft(const void* xr, const void* xi, void* y,
                            const void* tw, const void* half_tw,
                            long long batch, int n, const int* radices,
                            int nstages, float scale, int bf16,
                            void* stream) {
  return irfft_entry(xr, xi, y, tw, half_tw, batch, n, radices, nstages,
                     scale, bf16, true, stream);
}

// tpufft_irfft on the stage form at every length: the form that the line
// form's lengths ran before it, kept for comparison (chip_smoke.py times
// both).
extern "C" int tpufft_irfft_stages(const void* xr, const void* xi, void* y,
                                   const void* tw, const void* half_tw,
                                   long long batch, int n,
                                   const int* radices, int nstages,
                                   float scale, int bf16, void* stream) {
  return irfft_entry(xr, xi, y, tw, half_tw, batch, n, radices, nstages,
                     scale, bf16, false, stream);
}

// The form K7 and K8 launch at real length n (both alike): 0 the stage
// form; 2 the power-of-two four-step at the half m (K7's rfft_lane_kernel,
// K8's irfft_lane_kernel), out[0:9] = {N1, N2, warps a team, threads a
// block, rows a team, Q1, Q2, P2, RS} as tpufft_minor_line_geometry gives
// them (P2 = RS = 0: the XOR tile); 3 the mixed-radix four-step at the half
// m (rfft_mixed_kernel, irfft_mixed_kernel), out[0:9] K1's geometry at m
// and out[9:13] = {ZS, ZH of K7, ZS, ZH of K8}; 4 K1's four-step at odd n
// itself (rfft_odd_kernel, irfft_odd_kernel), out[0:9] its geometry.
extern "C" int tpufft_real_line_geometry(int n, int* out) {
  if (r2c_line_form(n))
    return tpufft_real::with_line_step(n, [&](auto step) {
      using S = decltype(step);
      const int v[9] = {S::N1, S::N2, S::lanes / 32, S::teams * S::lanes,
                        S::rows, S::Q1, S::Q2, 0, 0};
      for (int i = 0; i < 9; ++i) out[i] = v[i];
      return 2;
    });
  if (tpufft_real::real_family(n) == 0) return 0;
  const int m = n % 2 == 0 ? n / 2 : n;
  const tpufft_minor::MixedGeometry g = tpufft_minor::mixed_geometry(m);
  const int v[9] = {g.n1, g.n2, g.w, 128, g.r, g.q1, g.q2, g.p2, g.rs};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  if (n % 2 == 1) return 4;
#define TPUFFT_HALF_GEO(m_, zs7, zh7, zs8, zh8)   \
  if (m == m_) {                                  \
    const int w[4] = {zs7, zh7, zs8, zh8};        \
    for (int i = 0; i < 4; ++i) out[9 + i] = w[i]; \
  }
  TPUFFT_REAL_R3(TPUFFT_HALF_GEO)
  TPUFFT_REAL_R5(TPUFFT_HALF_GEO)
  TPUFFT_REAL_R15(TPUFFT_HALF_GEO)
  TPUFFT_REAL_ODD(TPUFFT_HALF_GEO)
#undef TPUFFT_HALF_GEO
  return 3;
}
