// The DFT of a power-of-two line (2 to 256) held in the registers of the
// lanes of one warp, which swap values by __shfl_xor_sync: no shared memory
// and no barrier. Shared by the line forms of the cube kernel and of the
// mid-pair kernel (cluster_fft.cu, cube_line_kernel, mid_pair_line_kernel;
// lines of 2 to 64 and 2 to 128), the mid-pair kernel's generic-radix form
// (mid_line.cuh, mid_mixed_kernel: the power-of-two sub-lines of r 2^a and
// lines of 256, on fewer values a lane, twiddles from a staged table) and
// the line form of the minor-axis kernel at n <= 64 (minor_fft.cuh,
// minor_lines_kernel).

#pragma once

#include <type_traits>

#include "fft_stages.cuh"

namespace tpufft_line {

using namespace tpufft_fft;

constexpr int kLineValues = 16;  // values a thread of the cube kernel holds

// Values a lane holds of a line of N: min(N, 8), and 16 from N = 128.
__host__ __device__ constexpr int line_values(int N) {
  return N < 8 ? N : (N >= 128 ? 16 : 8);
}

// A line of length N (a power of two, 2 to 256) on G lanes of a warp:
// lane `place` l of the line holds V of its values, input x[l + G j] in
// register j; a thread holds K lines at once; a warp holds W lines side by
// side, the lane of place l and slot c being l * W + c (the place in the
// high lane bits, so that the slots of a warp take consecutive lines).
// V = line_values(N) unless the caller picks fewer (kV): with G <= V a
// lane ends holding whole radix-G butterflies (line_fft's exchange), so a
// 128-line is 8 lanes of 16 values, one line a thread, and a 256-line 16
// lanes of 16; with G > V (line_core's lane stages) a lane holds fewer.
template <int N, int kV = line_values(N)>
struct Line {
  static constexpr int V = kV;
  static constexpr int G = N / V;
  static constexpr int K = kLineValues / V;
  static constexpr int W = 32 / G;
  static constexpr int Q = G <= V ? V / G : 1;
  static_assert(N >= 2 && N <= 256 && (N & (N - 1)) == 0, "line length");
  static_assert(V >= 1 && V <= N && G <= 32, "a line's lanes in a warp");
  // index in the line of input register j of place l
  static __device__ __forceinline__ int in(int l, int j) { return l + G * j; }
  // index in the line of output register r of place m (line_core): the
  // exchange's order, or the lane stages' bit-reversed places
  static __device__ __forceinline__ int out(int m, int r) {
    if constexpr (G <= V) {
      return m * Q + r % Q + V * (r / Q);
    } else {
      int b = 0;
#pragma unroll
      for (int i = 1; i < G; i <<= 1) b = (b << 1) | ((m & i) != 0);
      return r + V * b;
    }
  }
};

// W_16^m = exp(-+2 pi i m / 16) for the m = b2 k1 of butterfly16 (1, 2,
// 3, 4, 6, 9); a constant once the loops are unrolled.
__device__ __forceinline__ float2 w16(int m, bool inv) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f;
  constexpr float h = 0.70710678118654752f;
  float c = 0.f, s = 1.f;   // m = 4
  switch (m) {
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 9: c = -c1; s = -s1; break;
    default: break;
  }
  return make_float2(c, inv ? s : -s);
}

// In-register radix-16 DFT, x[k] <- sum_b x[b] W_16^(k b): radix 4 over
// b = 4 b1 + b2, the twiddle W_16^(b2 k1), radix 4 over b2.
__device__ __forceinline__ void butterfly16(float2 (&x)[16], bool inv) {
  float2 t[4][4];
#pragma unroll
  for (int b2 = 0; b2 < 4; ++b2) {
#pragma unroll
    for (int b1 = 0; b1 < 4; ++b1) t[b2][b1] = x[4 * b1 + b2];
    butterfly<4>(t[b2], inv);
    if (b2 == 0) continue;
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      t[b2][k1] = cmul(t[b2][k1], w16(b2 * k1, inv));
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 u[4] = {t[0][k1], t[1][k1], t[2][k1], t[3][k1]};
    butterfly<4>(u, inv);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) x[k1 + 4 * k2] = u[k2];
  }
}

template <int R>
__device__ __forceinline__ void line_butterfly(float2 (&x)[R], bool inv) {
  if constexpr (R == 16)
    butterfly16(x, inv);
  else if constexpr (R > 1)
    butterfly<R>(x, inv);
}

// The DFT of one line held as Line<N, kV> says, w^k (k < N, for the
// direction) from tw(k). X[a + V b] = sum_l w_G^(l b) w^(l a) sum_j x[l +
// G j] w_V^(j a): the radix-V butterfly over j in registers, the twiddle
// w^(l a), then the G-point DFTs over l across the lanes. With G <= V the
// values move so that lane m holds a in [m Q, m Q + Q) for every l (each
// exchange swaps bit i of the place with bit log2(Q) + i of the register,
// between lanes W << i apart), and radix-G butterflies over l run in
// registers. With G > V they run as log2 G radix-2 stages across the lanes
// (decimation in frequency: the place bit h, high to low, pairs lanes W h
// apart, the low one keeping the sum and the high one the difference times
// w_2h^(l mod h)), which leaves the places bit-reversed. Register r of
// place m ends holding X[Line<N, kV>::out(m, r)]. Every lane of the warp
// calls it together.
template <int N, int kV, typename Tw>
__device__ __forceinline__ void line_core(float2 (&v)[kV], int l,
                                          const Tw& tw, bool inv) {
  using L = Line<N, kV>;
  line_butterfly<L::V>(v, inv);
  if constexpr (L::G > 1) {
#pragma unroll
    for (int a = 1; a < L::V; ++a) v[a] = cmul(v[a], tw(l * a));
    if constexpr (L::G > L::V) {
#pragma unroll
      for (int h = L::G / 2; h >= 1; h >>= 1) {
        const bool hi = (l & h) != 0;
        const float2 w = hi ? tw((l & (h - 1)) * (N / (2 * h)))
                            : make_float2(1.f, 0.f);
#pragma unroll
        for (int a = 0; a < L::V; ++a) {
          float2 got;
          got.x = __shfl_xor_sync(0xffffffffu, v[a].x, L::W * h);
          got.y = __shfl_xor_sync(0xffffffffu, v[a].y, L::W * h);
          v[a] = cmul(hi ? csub(got, v[a]) : cadd(v[a], got), w);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; (1 << i) < L::G; ++i) {
        const int bit = L::Q << i;
        const bool hi = (l >> i) & 1;
#pragma unroll
        for (int r = 0; r < L::V; ++r) {
          if (r & bit) continue;
          const float2 send = hi ? v[r] : v[r | bit];
          float2 got;
          got.x = __shfl_xor_sync(0xffffffffu, send.x, L::W << i);
          got.y = __shfl_xor_sync(0xffffffffu, send.y, L::W << i);
          if (hi)
            v[r] = got;
          else
            v[r | bit] = got;
        }
      }
#pragma unroll
      for (int a = 0; a < L::Q; ++a) {
        float2 t[L::G];
#pragma unroll
        for (int b = 0; b < L::G; ++b) t[b] = v[b * L::Q + a];
        line_butterfly<L::G>(t, inv);
#pragma unroll
        for (int b = 0; b < L::G; ++b) v[b * L::Q + a] = t[b];
      }
    }
  }
}

// line_core of a Line<N> with tw[k kStride] = w^k read through the
// read-only cache: a table of length N (kStride 1), or of a multiple N
// kStride of it.
template <int N, int kStride = 1>
__device__ __forceinline__ void line_fft(float2 (&v)[Line<N>::V], int l,
                                         const float2* __restrict__ tw,
                                         bool inv) {
  line_core<N, Line<N>::V>(
      v, l, [&](int k) { return __ldg(&tw[k * kStride]); }, inv);
}

// line_core of a Line<N, kV> with w^k = table[pad(k kStride)], a table
// staged in shared memory (mid_line.cuh: the n-table of a line N kStride
// long whose sub-lines of N are strided by kStride).
template <int N, int kV, int kStride>
__device__ __forceinline__ void line_fft_staged(float2 (&v)[kV], int l,
                                                const float2* table,
                                                bool inv) {
  line_core<N, kV>(
      v, l, [&](int k) { return table[pad(k * kStride)]; }, inv);
}

// f(integral_constant<int, n>) for the line length n (2 to 64; with_length
// to 128 below).
template <class F>
__device__ __forceinline__ void with_length(int n, const F& f) {
  switch (n) {
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    default: f(std::integral_constant<int, 64>{}); break;
  }
}

// f(integral_constant<int, n>) for the line length n (2 to 128).
template <class F>
__device__ __forceinline__ void with_length128(int n, const F& f) {
  if (n == 128)
    f(std::integral_constant<int, 128>{});
  else
    with_length(n, f);
}

}  // namespace tpufft_line
