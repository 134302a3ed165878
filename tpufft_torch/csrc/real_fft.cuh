// Device code shared by the real-input transforms: K7's rfft and K8's irfft
// (real_fft.cu), K13's overlapped-frame STFT and K14's inverse STFT
// (stft_mm.cu), which all run a real row of even length n as m = n/2
// complex values z[j] = x[2j] + i x[2j+1] and untangle (forward) or tangle
// (inverse) its spectrum; and K7's and K8's mixed-radix line form (at the
// end), which runs K1's four-step body at such an m, or at an odd n itself.

#pragma once

#include "minor_fft.cuh"

namespace tpufft_real {

using namespace tpufft_fft;

// Two neighbouring reals p[i], p[i+1] (i even) as one complex value; the
// wrappers guarantee 8-byte (f32) or 4-byte (bf16) alignment of p.
__device__ __forceinline__ float2 load_pair(const float* p, int64_t i) {
  return *reinterpret_cast<const float2*>(p + i);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p,
                                            int64_t i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
}
__device__ __forceinline__ void store_pair(float* p, int64_t i, float2 v) {
  *reinterpret_cast<float2*>(p + i) = v;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int64_t i,
                                           float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __float22bfloat162_rn(v);
}

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
// The inverse-real line core of K8's and K14's line forms at a power-of-two
// half (the mixed-radix halves run C2rPacked below): the inverse real FFT
// of rows of n = 2m real samples, given as their m + 1 bins X[0..m], m =
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


// ---------------------------------------------------------------------------
// The mixed-radix line form of K7 and K8: K1's four-step (minor_fft.cuh,
// lane_steps on MixedStep, the family lists' geometry) with the real
// kernels' own load and hand-over (the policies below).
//
// - Even n = 2m, m a length of K1's family lists (TPUFFT_REAL_* below: 12
//   to 3840): the packed row z[j] = x[2j] + i x[2j+1], as the power-of-two
//   halves run it, but on K1's slot geometry at m. K7 (R2cPacked): pass 1
//   reads each pair as one 8-byte (bf16: 4-byte) load; pass 2 writes Z
//   back into the team's tile in natural order, at r ZS + k; after a team
//   barrier, lane t takes the pairs (k, m - k) of slot e = t + lanes i, r
//   = e / ZH, k = e mod ZH (live for k < H = ceil(m/2)), and stores X[k]
//   and X[m - k] (the lane of k = 0: X[0] and X[m]; at even m also X[m/2]
//   = conj Z[m/2], an odd m has no self-paired bin). K8 (C2rPacked): the
//   tangle of the same pairs writes Z' into the tile at r ZS + k, pass 1
//   reads its columns from there, and pass 2 stores z'[j] as the pair
//   (y[2j], y[2j+1]), one 8-byte (bf16: 4-byte) store. ZS and ZH (K7's
//   and K8's own, the lists' last four columns) were found by a search so
//   that every half warp of pass 2's Z writes and the untangle's reads
//   (K7), and of the tangle's writes and pass 1's reads (K8), touches
//   distinct bank pairs (tests/test_torch_kernel_real.py walks them); the
//   tile grows to R ZS where ZS exceeds K1's RS.
// - Odd n = 93 (TPUFFT_REAL_ODD_N): K1's four-step at n itself. K7
//   (R2cOdd) loads the real row as (x, 0), one plane, and stores only the
//   bins k <= n/2; K8 (C2rOdd) gathers X[j] for j <= n/2 and conj X[n - j]
//   above it (the imaginary part of the DC bin ignored) and stores the real
//   part.
// Blocks an SM and the launch bound are K1's at the same geometry
// (lane_min_blocks).
// ---------------------------------------------------------------------------

// The real lengths of the mixed-radix line form, one list a radix family
// (each instantiated by its own source, real_line_{r3,r5,r15,odd}.cu):
// X(m, ZS K7, ZH K7, ZS K8, ZH K8) for even n = 2m, K1's geometry at m;
// the odd n on K1's geometry at n. kernels/real_fft.py (_REAL_STEP,
// _ODD_LINES) lists the same, and a CPU test holds them equal.
#define TPUFFT_REAL_R3(X)       \
  X(12, 12, 16, 19, 16)         \
  X(24, 24, 16, 35, 16)         \
  X(48, 51, 32, 56, 24)         \
  X(96, 102, 48, 96, 48)        \
  X(192, 200, 96, 200, 96)      \
  X(384, 392, 192, 384, 192)    \
  X(768, 768, 384, 768, 384)    \
  X(1536, 1536, 768, 1536, 768) \
  X(3072, 3072, 1536, 3072, 1536)
#define TPUFFT_REAL_R5(X)       \
  X(20, 20, 16, 21, 16)         \
  X(40, 40, 24, 53, 27)         \
  X(80, 85, 48, 88, 40)         \
  X(160, 165, 80, 160, 80)      \
  X(320, 325, 160, 320, 160)    \
  X(640, 650, 320, 640, 320)    \
  X(1280, 1280, 640, 1280, 640) \
  X(2560, 2560, 1280, 2560, 1280)
#define TPUFFT_REAL_R15(X)      \
  X(30, 30, 16, 30, 16)         \
  X(60, 60, 32, 60, 32)         \
  X(120, 120, 64, 120, 64)      \
  X(240, 248, 120, 248, 120)    \
  X(480, 488, 240, 480, 240)    \
  X(960, 960, 480, 960, 480)    \
  X(1920, 1920, 960, 1920, 960) \
  X(3840, 3840, 1920, 3840, 1920)
#define TPUFFT_REAL_ODD(X)      \
  X(93, 93, 48, 99, 48)         \
  X(1000, 1000, 500, 1000, 500) \
  X(1080, 1080, 544, 1092, 544) \
  X(2160, 2160, 1080, 2160, 1080)
#define TPUFFT_REAL_ODD_N(X) X(93)
#define TPUFFT_REAL_NONE(X)

// K1's four-step at the half m, with the natural-order rows of the
// (un)tangle at stride kZS and kZH pair slots a row; the team's tile
// widened to R kZS where that exceeds K1's.
template <int m, int kZS, int kZH>
struct HalfStep : tpufft_minor::MixedStep<m> {
  using B = tpufft_minor::MixedStep<m>;
  static constexpr int ZS = kZS, ZH = kZH;
  static constexpr int H = (m + 1) / 2;  // pairs (k, m - k) a row
  static constexpr int tile =
      B::tile > B::rows * kZS ? B::tile : B::rows * kZS;
  static constexpr size_t smem = (size_t)(B::table + B::teams * tile) * 8;
  static constexpr int iters = (B::rows * kZH + B::lanes - 1) / B::lanes;
  // K7's untangle unrolled whole where a team holds at most 4 rows (m >=
  // 192), by 4 where it holds more (whole, it spilled 48-296 bytes there);
  // K8's tangle whole where the lines lie on lane pairs (three blocks an
  // SM), by 4 elsewhere. On the H100 (tools/mixed_line_ab.py --variants,
  // PERF.md) whole took K7 at 7680 from 0.68-0.69 to 0.65 ms and at 480
  // from 0.126 to 0.119, and K8 at 1920 from 0.514 to 0.346 and at 7680
  // from 1.074 to 0.706, where it spills 16-92 bytes; by 8 it did not
  // help, and at 480 (one lane a line) K8 took 0.142 by 4 against 0.145.
  static constexpr int untangle_unroll = B::rows <= 4 ? iters : 4;
  static constexpr int tangle_unroll = B::pair1 || B::pair2 ? iters : 4;
  static_assert(B::n == m && kZS >= m && kZH >= H, "half step");
};

// K7 at even n = 2m (the policy of tpufft_minor::lane_steps).
template <typename T, class S>
struct R2cPacked {
  const T* __restrict__ x;
  T* __restrict__ yr;
  T* __restrict__ yi;
  const float2* __restrict__ half_tw;
  int64_t batch;
  float scale;
  static constexpr int m = S::n, kTeamWarps = S::lanes / 32;
  __device__ __forceinline__ void begin(float2*, int, int, int64_t) {}
  __device__ __forceinline__ float2 load(const float2*, int, int64_t row,
                                         int col) const {
    return load_pair(x, row * (2 * m) + 2 * col);
  }
  __device__ __forceinline__ void held1(int) {}
  __device__ __forceinline__ void held2(int team) {
    tpufft_minor::team_sync<kTeamWarps>(team);  // every line read: Z lands
  }
  __device__ __forceinline__ void put(float2* tile, int r, int64_t, int k,
                                      float2 y) const {
    tile[r * S::ZS + k] = y;
  }
  // the untangle: X[k] = (s - u) / 2, X[m-k] = conj(s + u) / 2, s = Z[k] +
  // conj Z[m-k], u = i W^k (Z[k] - conj Z[m-k]), Z[m-0] = Z[0]
  __device__ __forceinline__ void end(float2* tile, int t, int team,
                                      int64_t row0) const {
    tpufft_minor::team_sync<kTeamWarps>(team);
    const float hs = 0.5f * scale;
    constexpr int kUnroll = S::untangle_unroll;
#pragma unroll (kUnroll)
    for (int i = 0; i < S::iters; ++i) {
      const int e = t + S::lanes * i;
      const int r = e / S::ZH, k = e - r * S::ZH;
      const int64_t row = row0 + r;
      if (r < S::rows && k < S::H && row < batch) {
        const float2* z = tile + r * S::ZS;
        const float2 a = z[k];  // Z[k]
        float2 b = a;           // Z[m-k]
        if (k != 0) b = z[m - k];
        const float2 s = make_float2(a.x + b.x, a.y - b.y);
        const float2 wd = cmul(__ldg(&half_tw[k]),
                               make_float2(a.x - b.x, a.y + b.y));
        const int64_t out = row * (m + 1);
        store_f(yr, out + k, hs * (s.x + wd.y));
        store_f(yi, out + k, hs * (s.y - wd.x));
        store_f(yr, out + m - k, hs * (s.x - wd.y));
        store_f(yi, out + m - k, -hs * (s.y + wd.x));
        if constexpr (m % 2 == 0) {
          if (k == 0) {
            const float2 c = z[m / 2];  // X[m/2] = conj Z[m/2]
            store_f(yr, out + m / 2, c.x * scale);
            store_f(yi, out + m / 2, -c.y * scale);
          }
        }
      }
    }
  }
};

// K8 at even n = 2m: the tangle into the tile before pass 1, the pairs
// stored after pass 2.
template <typename T, class S>
struct C2rPacked {
  const T* __restrict__ xr;
  const T* __restrict__ xi;
  T* __restrict__ y;
  const float2* __restrict__ half_tw;
  int64_t batch;
  float scale;
  static constexpr int m = S::n, kTeamWarps = S::lanes / 32;
  // Z'[k] = (X[k] + conj X[m-k]) + i conj(W^k) (X[k] - conj X[m-k]),
  // Z'[m-k] likewise with k and m - k swapped (conj W^(m-k) = -W^k); the
  // lane of k = 0 reads the Nyquist bin as X[m - k] and, at even m, writes
  // Z'[m/2] = 2 conj X[m/2]. The imaginary parts of DC and Nyquist are
  // ignored.
  __device__ __forceinline__ void begin(float2* tile, int t, int team,
                                        int64_t row0) const {
    constexpr int kUnroll = S::tangle_unroll;
#pragma unroll (kUnroll)
    for (int i = 0; i < S::iters; ++i) {
      const int e = t + S::lanes * i;
      const int r = e / S::ZH, k = e - r * S::ZH;
      const int64_t row = row0 + r;
      if (r < S::rows && k < S::H) {
        const int64_t at = row * (m + 1);
        float2 a = make_float2(0.f, 0.f), b = a;
        if (row < batch) {
          a = make_float2(load_f(xr, at + k), load_f(xi, at + k));
          b = make_float2(load_f(xr, at + m - k), load_f(xi, at + m - k));
        }
        if (k == 0) a.y = b.y = 0.f;
        const float2 w = __ldg(&half_tw[k]);
        float2* z = tile + r * S::ZS;
        const float2 wd = cmul(make_float2(w.x, -w.y),
                               make_float2(a.x - b.x, a.y + b.y));
        z[k] = make_float2(a.x + b.x - wd.y, a.y - b.y + wd.x);
        if (k != 0) {
          const float2 wd2 = cmul(w, make_float2(b.x - a.x, b.y + a.y));
          z[m - k] = make_float2(b.x + a.x + wd2.y, b.y - a.y - wd2.x);
        }
        if constexpr (m % 2 == 0) {
          if (k == 0) {
            const float2 c =
                row < batch ? make_float2(load_f(xr, at + m / 2),
                                          load_f(xi, at + m / 2))
                            : make_float2(0.f, 0.f);
            z[m / 2] = make_float2(2.f * c.x, -2.f * c.y);
          }
        }
      }
    }
    tpufft_minor::team_sync<kTeamWarps>(team);
  }
  __device__ __forceinline__ float2 load(const float2* tile, int r, int64_t,
                                         int col) const {
    return tile[r * S::ZS + col];
  }
  __device__ __forceinline__ void held1(int team) {
    tpufft_minor::team_sync<kTeamWarps>(team);  // every column is read
  }
  __device__ __forceinline__ void held2(int) {}
  __device__ __forceinline__ void put(float2*, int, int64_t row, int k,
                                      float2 v) const {
    store_pair(y, row * (2 * m) + 2 * k, make_float2(v.x * scale, v.y * scale));
  }
  __device__ __forceinline__ void end(float2*, int, int, int64_t) {}
};

// K7 at odd n: the real row as (x, 0), the bins k <= n/2 stored.
template <typename T, int n>
struct R2cOdd {
  const T* __restrict__ x;
  T* __restrict__ yr;
  T* __restrict__ yi;
  float scale;
  __device__ __forceinline__ void begin(float2*, int, int, int64_t) {}
  __device__ __forceinline__ float2 load(const float2*, int, int64_t row,
                                         int col) const {
    return make_float2(load_f(x, row * n + col), 0.f);
  }
  __device__ __forceinline__ void held1(int) {}
  __device__ __forceinline__ void held2(int) {}
  __device__ __forceinline__ void put(float2*, int, int64_t row, int k,
                                      float2 v) const {
    if (k <= n / 2) {
      const int64_t out = row * (n / 2 + 1) + k;
      store_f(yr, out, v.x * scale);
      store_f(yi, out, v.y * scale);
    }
  }
  __device__ __forceinline__ void end(float2*, int, int, int64_t) {}
};

// K8 at odd n: X[j] for j <= n/2 and conj X[n - j] above it (the DC bin's
// imaginary part ignored), the real part stored.
template <typename T, int n>
struct C2rOdd {
  const T* __restrict__ xr;
  const T* __restrict__ xi;
  T* __restrict__ y;
  float scale;
  __device__ __forceinline__ void begin(float2*, int, int, int64_t) {}
  __device__ __forceinline__ float2 load(const float2*, int, int64_t row,
                                         int col) const {
    const int src = col <= n / 2 ? col : n - col;
    const int64_t at = row * (n / 2 + 1) + src;
    const float im = src == 0 ? 0.f : load_f(xi, at);
    return make_float2(load_f(xr, at), src == col ? im : -im);
  }
  __device__ __forceinline__ void held1(int) {}
  __device__ __forceinline__ void held2(int) {}
  __device__ __forceinline__ void put(float2*, int, int64_t row, int k,
                                      float2 v) const {
    store_f(y, row * n + k, v.x * scale);
  }
  __device__ __forceinline__ void end(float2*, int, int, int64_t) {}
};

template <typename T, class S>
__global__ void __launch_bounds__(128, (tpufft_minor::lane_min_blocks<S, 128>()))
rfft_mixed_kernel(const T* __restrict__ x, T* __restrict__ yr,
                  T* __restrict__ yi, const float2* __restrict__ tw,
                  const float2* __restrict__ half_tw, int64_t batch,
                  float scale) {
  R2cPacked<T, S> io{x, yr, yi, half_tw, batch, scale};
  tpufft_minor::lane_steps<S, 128>(io, tw, batch, 0);
}

template <typename T, class S>
__global__ void __launch_bounds__(128, (tpufft_minor::lane_min_blocks<S, 128>()))
irfft_mixed_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                   T* __restrict__ y, const float2* __restrict__ tw,
                   const float2* __restrict__ half_tw, int64_t batch,
                   float scale) {
  C2rPacked<T, S> io{xr, xi, y, half_tw, batch, scale};
  tpufft_minor::lane_steps<S, 128>(io, tw, batch, 1);
}

template <typename T, int n>
__global__ void __launch_bounds__(
    128, (tpufft_minor::lane_min_blocks<tpufft_minor::MixedStep<n>, 128>()))
rfft_odd_kernel(const T* __restrict__ x, T* __restrict__ yr,
                T* __restrict__ yi, const float2* __restrict__ tw,
                int64_t batch, float scale) {
  R2cOdd<T, n> io{x, yr, yi, scale};
  tpufft_minor::lane_steps<tpufft_minor::MixedStep<n>, 128>(io, tw, batch, 0);
}

template <typename T, int n>
__global__ void __launch_bounds__(
    128, (tpufft_minor::lane_min_blocks<tpufft_minor::MixedStep<n>, 128>()))
irfft_odd_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ y, const float2* __restrict__ tw,
                 int64_t batch, float scale) {
  C2rOdd<T, n> io{xr, xi, y, scale};
  tpufft_minor::lane_steps<tpufft_minor::MixedStep<n>, 128>(io, tw, batch, 1);
}

// One launch's operands: K7 reads x = xr into (yr, yi), K8 reads (xr, xi)
// into y = yr.
struct RealArgs {
  const void *xr, *xi;
  void *yr, *yi;
  const void *tw, *half_tw;
  long long batch;
  float scale;
  cudaStream_t stream;
};

// A line-form kernel (K7's or K8's) on geometry S: a grid of at most the
// blocks the card holds at once, each staging the table once and looping
// over row groups.
template <class S, class Kernel, class... Args>
int launch_lane(Kernel kernel, long long batch, cudaStream_t stream,
                Args... args) {
  constexpr int threads = S::teams * S::lanes;
  constexpr long long rows = S::teams * S::rows;
  unsigned blocks = 0;
  cudaError_t err = allow_smem(kernel, S::smem);
  if (err == cudaSuccess)
    err = tpufft_minor::resident_grid(kernel, threads, S::smem,
                                      (batch + rows - 1) / rows, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, S::smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, class S, bool kInverse>
int launch_packed(const RealArgs& a) {
  const float2* tw = static_cast<const float2*>(a.tw);
  const float2* half = static_cast<const float2*>(a.half_tw);
  if constexpr (kInverse)
    return launch_lane<S>(irfft_mixed_kernel<T, S>, a.batch, a.stream,
                          static_cast<const T*>(a.xr),
                          static_cast<const T*>(a.xi), static_cast<T*>(a.yr),
                          tw, half, (int64_t)a.batch, a.scale);
  else
    return launch_lane<S>(rfft_mixed_kernel<T, S>, a.batch, a.stream,
                          static_cast<const T*>(a.xr), static_cast<T*>(a.yr),
                          static_cast<T*>(a.yi), tw, half, (int64_t)a.batch,
                          a.scale);
}

template <typename T, int n>
int launch_odd(const RealArgs& a, bool inverse) {
  using S = tpufft_minor::MixedStep<n>;
  const float2* tw = static_cast<const float2*>(a.tw);
  if (inverse)
    return launch_lane<S>(irfft_odd_kernel<T, n>, a.batch, a.stream,
                          static_cast<const T*>(a.xr),
                          static_cast<const T*>(a.xi), static_cast<T*>(a.yr),
                          tw, (int64_t)a.batch, a.scale);
  return launch_lane<S>(rfft_odd_kernel<T, n>, a.batch, a.stream,
                        static_cast<const T*>(a.xr), static_cast<T*>(a.yr),
                        static_cast<T*>(a.yi), tw, (int64_t)a.batch,
                        a.scale);
}

// The launchers of each family: K7 (inverse false) or K8 at real length n
// in storage T, or cudaErrorInvalidValue for a length the family does not
// hold.
template <typename T>
int launch_real_r3(const RealArgs& a, int n, bool inverse);
template <typename T>
int launch_real_r5(const RealArgs& a, int n, bool inverse);
template <typename T>
int launch_real_r15(const RealArgs& a, int n, bool inverse);
template <typename T>
int launch_real_odd(const RealArgs& a, int n, bool inverse);

// The family source that holds real length n on the mixed-radix line
// form: 3, 5, 15 or 1 (the odd list and the odd n), 0 for none.
inline int real_family(int n) {
#define TPUFFT_IS_HALF(m_, ...) || n == 2 * m_
#define TPUFFT_IS_N(n_) || n == n_
  if (false TPUFFT_REAL_R3(TPUFFT_IS_HALF)) return 3;
  if (false TPUFFT_REAL_R5(TPUFFT_IS_HALF)) return 5;
  if (false TPUFFT_REAL_R15(TPUFFT_IS_HALF)) return 15;
  if (false TPUFFT_REAL_ODD(TPUFFT_IS_HALF) TPUFFT_REAL_ODD_N(TPUFFT_IS_N))
    return 1;
#undef TPUFFT_IS_HALF
#undef TPUFFT_IS_N
  return 0;
}

template <typename T>
int launch_real_mixed(const RealArgs& a, int n, bool inverse) {
  switch (real_family(n)) {
    case 3: return launch_real_r3<T>(a, n, inverse);
    case 5: return launch_real_r5<T>(a, n, inverse);
    case 15: return launch_real_r15<T>(a, n, inverse);
    case 1: return launch_real_odd<T>(a, n, inverse);
  }
  return (int)cudaErrorInvalidValue;
}

// The body of each family's source: its switch over n (LIST's halves,
// ODD's odd lengths) and the launcher's two instantiations (f32, bf16).
#define TPUFFT_REAL_CASE(m_, zs7, zh7, zs8, zh8)                   \
  case 2 * m_:                                                     \
    return inverse                                                 \
               ? launch_packed<T, HalfStep<m_, zs8, zh8>, true>(a) \
               : launch_packed<T, HalfStep<m_, zs7, zh7>, false>(a);
#define TPUFFT_REAL_ODD_CASE(n_) \
  case n_:                       \
    return launch_odd<T, n_>(a, inverse);
#define TPUFFT_REAL_FAMILY(NAME, LIST, ODD)                              \
  template <typename T>                                                  \
  int NAME(const RealArgs& a, int n, bool inverse) {                     \
    switch (n) {                                                         \
      LIST(TPUFFT_REAL_CASE)                                             \
      ODD(TPUFFT_REAL_ODD_CASE)                                          \
    }                                                                    \
    return (int)cudaErrorInvalidValue;                                   \
  }                                                                      \
  template int NAME<float>(const RealArgs&, int, bool);                  \
  template int NAME<__nv_bfloat16>(const RealArgs&, int, bool);

}  // namespace tpufft_real
