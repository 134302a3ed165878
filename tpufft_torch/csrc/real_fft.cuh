// Device code shared by the real-input transforms: K7's rfft and K8's irfft
// (real_fft.cu), K13's overlapped-frame STFT and K14's inverse STFT
// (stft_mm.cu), which all run a real row of even length n as m = n/2
// complex values z[j] = x[2j] + i x[2j+1] and untangle (forward) or tangle
// (inverse) its spectrum.

#pragma once

#include "minor_fft.cuh"

namespace tpufft_real {

using namespace tpufft_fft;

// Bin k (0 <= k <= m) of the rfft of a real row of length n = 2m whose
// packed length-m DFT Z lies in buf at pad(row0 + j), j < m:
//   X[k] = (Z[k] + conj Z[m-k]) / 2 - i W^k (Z[k] - conj Z[m-k]) / 2,
// Z[m] = Z[0], with half_tw[k] = W^k = exp(-2 pi i k / n).
__device__ __forceinline__ float2 untangle(const float2* buf, int row0,
                                           int m, int k,
                                           const float2* __restrict__ half_tw) {
  const float2 a = buf[pad(row0 + (k == m ? 0 : k))];   // Z[k]
  const float2 b = buf[pad(row0 + (k == 0 ? 0 : m - k))];  // Z[m-k]
  const float2 s = make_float2(a.x + b.x, a.y - b.y);  // Z + conj Zm
  const float2 wd = cmul(__ldg(&half_tw[k]), make_float2(a.x - b.x, a.y + b.y));
  return make_float2(0.5f * (s.x + wd.y), 0.5f * (s.y - wd.x));  // - i wd
}

// ---------------------------------------------------------------------------
// The inverse-real line core of K8's and K14's line forms: the inverse real
// FFT of rows of n = 2m real samples, given as their m + 1 bins X[0..m], m =
// N1 N2 a power of two from 128 to 4096, on the geometry of K1's line form
// at m (minor_fft.cuh: LaneStep S, a team of S::lanes lanes holding S::rows
// rows in its tile of S::rows m float2, the inverse w_m table staged at
// `table`).
//
// 1. The tangle: lane t takes the pairs (k, m - k) of e = t + lanes i, r = e
//    / (m/2), k = e mod (m/2), reads X[k] and X[m - k] of team row r through
//    the caller's bin(r, k) (consecutive lanes on consecutive k: an
//    ascending and a descending run of each plane), and writes
//      Z'[k]     = (X[k] + conj X[m-k]) + i conj(W^k) (X[k] - conj X[m-k]),
//      Z'[m - k] = (X[m-k] + conj X[k]) - i W^k (X[m-k] - conj X[k])
//    (conj W^(m-k) = -W^k), W^k = half_tw[k]; the lane of k = 0 reads the
//    Nyquist bin X[m] as X[m - k] and also writes Z'[m/2] = 2 conj X[m/2].
//    The imaginary parts of the DC and Nyquist bins are ignored. Z' = 2 Z
//    of tpufft's packed inverse: the factor 2 folds into the caller's scale
//    (1/n is numpy's irfft). The tile holds Z' of row r at r m + k, in
//    natural order: every half warp of the tangle's writes and of pass 1's
//    reads lies in one row (m/2 >= 64 pairs a row, N2 >= 16 columns), on 16
//    consecutive positions, so each touches 16 bank pairs without a swizzle
//    (tests/test_torch_kernel_real.py counts them).
// 2. One team barrier, then K1's inverse four-step at m: pass 1 reads the
//    N1-long column lines j2 from the tile, transforms them in registers,
//    and (after a team barrier: every column is read before one is
//    overwritten) writes them back times w^(k1 j2) at K1's positions r m +
//    k1 N2 + (j2 ^ ((k1 + N1 r) mod 16)); a team barrier; pass 2 reads the
//    N2-long rows k1 and transforms them.
// 3. Pass 2 leaves z'[j] = (x[2j], x[2j+1]) (unscaled) of team row r =
//    line / N1 at j = k1 + N1 k2 in registers, lanes on consecutive j: the
//    caller's epilogue (for_each_pair) stores or stages them.
// ---------------------------------------------------------------------------

// The line form's geometry at an even real length n = 2m, m a power of two
// from 128 to 4096: f(LaneStep<N1, N2, warps a team, threads a block>{}),
// the power-of-two four-step of K1's line form at length m (minor_fft.cu,
// launch_line_form, up to 2048; K1 takes three factors at 4096), shared
// by K7's and K8's line forms and, for m up to 512 (one-warp teams of a
// 128-thread block), K14's; cudaErrorInvalidValue at any other n
// (kernels/real_fft.py, _HALF_STEP, lists the same geometries).
template <class F>
int with_line_step(int n, F&& f) {
  using tpufft_minor::LaneStep;
  switch (n / 2) {
    case 128: return f(LaneStep<8, 16, 1, 128>{});
    case 256: return f(LaneStep<16, 16, 1, 128>{});
    case 512: return f(LaneStep<32, 16, 1, 128>{});
    case 1024: return f(LaneStep<32, 32, 1, 128>{});
    case 2048: return f(LaneStep<32, 64, 2, 128>{});
    case 4096: return f(LaneStep<64, 64, 4, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <class S>
struct LineCore {
  static constexpr int V1 = S::pair1 ? 32 : S::N1;  // values of a pass-1 line
  static constexpr int V2 = S::pair2 ? 32 : S::N2;  // and of a pass-2 line
  static constexpr int kTeamWarps = S::lanes / 32;
  using Out = float2[S::L2][V2];
};

// Step 1. bin(r, k) returns X[k] (0 <= k <= m) of team row r as f32 (rows
// past the caller's data: zeros). Unrolled whole for teams of one or two
// warps, by 4 for four-warp teams (as K7's untangle).
template <class S, class Bin>
__device__ __forceinline__ void tangle(float2* tile, int t,
                                       const float2* __restrict__ half_tw,
                                       Bin&& bin) {
  constexpr int m = S::n, H = m / 2;
  constexpr int kIters = S::rows * H / S::lanes;
  constexpr int kUnroll = S::lanes <= 64 ? kIters : 4;
#pragma unroll (kUnroll)
  for (int i = 0; i < kIters; ++i) {
    const int e = t + S::lanes * i;
    const int r = e / H, k = e % H;
    float2 a = bin(r, k);      // X[k]
    float2 b = bin(r, m - k);  // X[m-k]; the Nyquist bin at k = 0
    if (k == 0) a.y = b.y = 0.f;
    const float2 w = __ldg(&half_tw[k]);
    float2* z = tile + r * m;
    const float2 wd = cmul(make_float2(w.x, -w.y),
                           make_float2(a.x - b.x, a.y + b.y));
    z[k] = make_float2(a.x + b.x - wd.y, a.y - b.y + wd.x);
    if (k == 0) {
      const float2 c = bin(r, H);
      z[H] = make_float2(2.f * c.x, -2.f * c.y);
    } else {
      const float2 wd2 = cmul(w, make_float2(b.x - a.x, b.y + a.y));
      z[m - k] = make_float2(b.x + a.x + wd2.y, b.y - a.y - wd2.x);
    }
  }
}

// Steps 2 and 3 after the tangle: the team barrier, pass 1 through the tile,
// pass 2 into v (register q of line s: z'[k1 + N1 line_out<N2>(p, q)] of
// row line / N1, line = lane_line(t, s), k1 = line mod N1).
template <class S>
__device__ __forceinline__ void inverse_passes(float2* tile,
                                               const float2* table, int team,
                                               int t,
                                               typename LineCore<S>::Out& v) {
  using C = LineCore<S>;
  using tpufft_lane::lane_dft;
  using tpufft_lane::pair_dft;
  using tpufft_minor::lane_line;
  using tpufft_minor::line_out;
  constexpr int N1 = S::N1, N2 = S::N2, m = S::n;
  const int p = (t >> 4) & 1;  // place in a lane pair
  tpufft_minor::team_sync<C::kTeamWarps>(team);
  {  // pass 1: the columns j2, from the tile and back into it
    float2 u[S::L1][C::V1];
#pragma unroll
    for (int s = 0; s < S::L1; ++s) {
      const int line = lane_line<S::pair1, S::lanes>(t, s);
      const float2* src = tile + (line / N2) * m + line % N2;
#pragma unroll
      for (int j = 0; j < C::V1; ++j)
        u[s][j] = src[N2 * (S::pair1 ? p + 2 * j : j)];
    }
#pragma unroll
    for (int s = 0; s < S::L1; ++s) {
      if constexpr (S::pair1)
        pair_dft<32, m / 64>(u[s], p, table, true);
      else
        lane_dft<N1, m / N1, 0, 1>(u[s], table, true);
    }
    tpufft_minor::team_sync<C::kTeamWarps>(team);  // every column is read
#pragma unroll
    for (int s = 0; s < S::L1; ++s) {
      const int line = lane_line<S::pair1, S::lanes>(t, s);
      const int r = line / N2, j2 = line % N2;
      float2* dst = tile + r * m;
#pragma unroll
      for (int q = 0; q < C::V1; ++q) {
        const int k1 = line_out<N1>(p, q);
        dst[k1 * N2 + (j2 ^ ((k1 + N1 * r) & 15))] =
            cmul(u[s][q], table[pad(k1 * j2)]);
      }
    }
  }
  tpufft_minor::team_sync<C::kTeamWarps>(team);
  // pass 2: the rows k1 of the tile, into v
#pragma unroll
  for (int s = 0; s < S::L2; ++s) {
    const int line = lane_line<S::pair2, S::lanes>(t, s);
    const float2* src = tile + (line / N1) * m + (line % N1) * N2;
#pragma unroll
    for (int j = 0; j < C::V2; ++j)
      v[s][j] = src[(S::pair2 ? p + 2 * j : j) ^ (line & 15)];
  }
#pragma unroll
  for (int s = 0; s < S::L2; ++s) {
    if constexpr (S::pair2)
      pair_dft<32, m / 64>(v[s], p, table, true);
    else
      lane_dft<N2, m / N2, 0, 1>(v[s], table, true);
  }
}

// The epilogue's walk: f(r, j, z) for each value z = z'[j] of team row r
// that lane t holds after inverse_passes; consecutive lanes on consecutive j.
template <class S, class F>
__device__ __forceinline__ void for_each_pair(
    int t, const typename LineCore<S>::Out& v, F&& f) {
  using tpufft_minor::lane_line;
  using tpufft_minor::line_out;
  const int p = (t >> 4) & 1;
#pragma unroll
  for (int s = 0; s < S::L2; ++s) {
    const int line = lane_line<S::pair2, S::lanes>(t, s);
    const int r = line / S::N1, k1 = line % S::N1;
#pragma unroll
    for (int q = 0; q < LineCore<S>::V2; ++q)
      f(r, k1 + S::N1 * line_out<S::N2>(p, q), v[s][q]);
  }
}

}  // namespace tpufft_real
