// The DFT of a power-of-two line (2 to 64) held in the registers of the
// lanes of one warp, which swap values by __shfl_xor_sync: no shared memory
// and no barrier. Shared by the line form of the cube kernel
// (cluster_fft.cu, cube_line_kernel) and the line form of the minor-axis
// kernel at n <= 64 (minor_fft.cuh, minor_lines_kernel).

#pragma once

#include <type_traits>

#include "fft_stages.cuh"

namespace tpufft_line {

using namespace tpufft_fft;

constexpr int kLineValues = 16;  // values a thread of the cube kernel holds

// A line of length N (a power of two, 2 to 64) on G lanes of a warp: lane
// `place` l of the line holds V of its values, input x[l + G j] in register
// j; a thread holds K lines at once; a warp holds W lines side by side, the
// lane of place l and slot c being l * W + c (the place in the high lane
// bits, so that the slots of a warp take consecutive lines).
template <int N>
struct Line {
  static constexpr int V = N < 8 ? N : 8;
  static constexpr int G = N / V;
  static constexpr int K = kLineValues / V;
  static constexpr int W = 32 / G;
  static constexpr int Q = V / G;
  static_assert(N >= 2 && N <= 64 && (N & (N - 1)) == 0, "line length");
  // index in the line of input register j of place l
  static __device__ __forceinline__ int in(int l, int j) { return l + G * j; }
  // index in the line of output register r of place m (line_fft)
  static __device__ __forceinline__ int out(int m, int r) {
    return m * Q + r % Q + V * (r / Q);
  }
};

// The DFT of one line held as Line<N> says (tw: w^k, k < N, for the
// direction). X[a + V b] = sum_l w_G^(l b) w^(l a) sum_j x[l + G j]
// w_V^(j a): the radix-V butterfly over j in registers, the twiddle w^(l a),
// then the values move so that lane m holds a in [m Q, m Q + Q) for every
// l (each exchange swaps bit i of the place with bit log2(Q) + i of the
// register, between lanes W << i apart), and radix-G butterflies over l.
// Register r of place m ends holding X[Line<N>::out(m, r)]. Every lane of
// the warp calls it together. tw[k kStride] is w^k: a table of length N
// (kStride 1), or of a multiple N kStride of it.
template <int N, int kStride = 1>
__device__ __forceinline__ void line_fft(float2 (&v)[Line<N>::V], int l,
                                         const float2* __restrict__ tw,
                                         bool inv) {
  using L = Line<N>;
  butterfly<L::V>(v, inv);
  if constexpr (L::G > 1) {
#pragma unroll
    for (int a = 1; a < L::V; ++a)
      v[a] = cmul(v[a], __ldg(&tw[l * a * kStride]));
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
      butterfly<L::G>(t, inv);
#pragma unroll
      for (int b = 0; b < L::G; ++b) v[b * L::Q + a] = t[b];
    }
  }
}

// f(integral_constant<int, n>) for the line length n (2 to 64).
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

}  // namespace tpufft_line
