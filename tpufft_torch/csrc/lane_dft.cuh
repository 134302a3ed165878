// Generic-radix DFTs held wholly in one lane's registers (or on a lane
// pair), shared by the two line forms of the port: the minor-axis kernel's
// (minor_fft.cuh: K1, K9, K20) and the strided kernel's (strided_line.cuh:
// K2, K3, K18, K19).
//
// A line of N = 2^a 3^b 5^c 7^d ... 31^e values (prime factors up to 31)
// is a Cooley-Tukey recursion in one lane (lane_dft): the first radix A of
// N (first_radix: 8, 4 or 2 while N has them, then its odd primes in
// ascending order) runs over the registers x[b + B a] for each b < B = N /
// A, each output times W_N^(a b), then the B-long sub-lines a. No value
// leaves the lane, so a radix costs no shared-memory round trip and no
// barrier. The radices:
// - 2, 4, 8: the exact butterflies of fft_stages.cuh;
// - 3, 5: the direct sums with their constants as f32 literals of their
//   f64 values (dft3, dft5);
// - an odd prime P from 7 to 31: a conjugate-pair direct sum (prime_emit).
//   The sums a_b = x_b + x_(P-b) and differences d_b = x_b - x_(P-b), b <=
//   P/2, are formed once in place; then each output pair is X_j, X_(P-j) =
//   x0 + sum_b a_b c_jb +- i sum_b d_b s_jb, with W_P^(j b) = c_jb + i s_jb
//   read from the staged n-table at pad((j b mod P) n / P) (the table holds
//   w^k for the direction, so the inverse needs no sign of its own; no
//   device trig). At P = 31 that is 15 x 15 table reads and 900 FMAs a
//   line, against 31 loads and stores: the pass stays bound by bytes.
// Where the largest prime of a line is 7 or more, the line's outputs are
// handed to a consumer as they are formed (lane_dft_emit): the consumer
// writes each to the tile or to device memory, so the P outputs of the
// last radix never sit in registers beside its P inputs (a 31-long line
// holds 62 floats, not 124).
//
// The same recursion with the same radices and twiddle indices runs in
// torch ops in tests/test_torch_kernel_inner.py (the strided model) and
// tests/test_torch_kernel_minor.py (the lane_dft model against np.fft).

#pragma once

#include <utility>

#include "fft_stages.cuh"

namespace tpufft_lane {

using namespace tpufft_fft;

// The smallest odd prime factor of an odd N > 1 (N itself when prime).
__host__ __device__ constexpr int odd_prime(int N) {
  for (int p = 3; p * p <= N; p += 2)
    if (N % p == 0) return p;
  return N;
}

// The largest prime factor of N >= 1 (1 for N = 1).
__host__ __device__ constexpr int max_prime(int N) {
  int best = 1;
  for (int p = 2; p <= N; ++p)
    while (N % p == 0) {
      best = p;
      N /= p;
    }
  return best;
}

// The first radix of a lane line of N: 8 (4 at N = 16), 4, 2, then the
// smallest odd prime.
__host__ __device__ constexpr int first_radix(int N) {
  return N % 8 == 0 && N != 16 ? 8
         : N % 4 == 0           ? 4
         : N % 2 == 0           ? 2
                                : odd_prime(N);
}

// Radix 3: X1, X2 = x0 - (x1 + x2) / 2 -+ i sin(2 pi / 3) (x1 - x2) forward
// (+- inverse).
__device__ __forceinline__ void dft3(float2 (&x)[3], bool inv) {
  const float s = inv ? -0.86602540378443864676f : 0.86602540378443864676f;
  const float2 t = cadd(x[1], x[2]), d = csub(x[1], x[2]);
  const float2 m = make_float2(x[0].x - 0.5f * t.x, x[0].y - 0.5f * t.y);
  x[0] = cadd(x[0], t);
  x[1] = make_float2(m.x + s * d.y, m.y - s * d.x);
  x[2] = make_float2(m.x - s * d.y, m.y + s * d.x);
}

// Radix 5, in conjugate pairs: with a_b = x_b + x_(5-b), d_b = x_b -
// x_(5-b), X1, X4 = x0 + c1 a1 + c2 a2 -+ i (s1 d1 + s2 d2) and X2, X3 =
// x0 + c2 a1 + c1 a2 -+ i (s2 d1 - s1 d2) forward (c_k = cos(2 pi k / 5),
// s_k = sin(2 pi k / 5); the signs of s flip inverse).
__device__ __forceinline__ void dft5(float2 (&x)[5], bool inv) {
  const float c1 = 0.30901699437494742410f, c2 = -0.80901699437494742410f;
  const float s1 = inv ? -0.95105651629515357212f : 0.95105651629515357212f;
  const float s2 = inv ? -0.58778525229247312917f : 0.58778525229247312917f;
  const float2 a1 = cadd(x[1], x[4]), d1 = csub(x[1], x[4]);
  const float2 a2 = cadd(x[2], x[3]), d2 = csub(x[2], x[3]);
  const float2 m1 = make_float2(x[0].x + c1 * a1.x + c2 * a2.x,
                                x[0].y + c1 * a1.y + c2 * a2.y);
  const float2 m2 = make_float2(x[0].x + c2 * a1.x + c1 * a2.x,
                                x[0].y + c2 * a1.y + c1 * a2.y);
  const float2 e1 = make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y);
  const float2 e2 = make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y);
  x[0] = cadd(x[0], cadd(a1, a2));
  x[1] = make_float2(m1.x + e1.y, m1.y - e1.x);
  x[4] = make_float2(m1.x - e1.y, m1.y + e1.x);
  x[2] = make_float2(m2.x + e2.y, m2.y - e2.x);
  x[3] = make_float2(m2.x - e2.y, m2.y + e2.x);
}

// An odd prime P >= 7 in conjugate pairs (the header's notes): t is
// clobbered, and emit(k, X_k) receives each output once, X_0 first, then
// X_j and X_(P-j) for j = 1 .. P/2. W_P^k = table[pad(k kStep)].
template <int P, int kStep, typename Emit>
__device__ __forceinline__ void prime_emit(float2 (&t)[P], const float2* table,
                                           const Emit& emit) {
  constexpr int H = P / 2;
  float2 s = t[0];
#pragma unroll
  for (int b = 1; b <= H; ++b) {
    const float2 a = cadd(t[b], t[P - b]), d = csub(t[b], t[P - b]);
    t[b] = a;
    t[P - b] = d;
    s = cadd(s, a);
  }
  emit(0, s);
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    float2 c = t[0], e = make_float2(0.f, 0.f);
#pragma unroll
    for (int b = 1; b <= H; ++b) {
      const float2 w = table[pad((j * b) % P * kStep)];
      c.x += w.x * t[b].x;
      c.y += w.x * t[b].y;
      e.x += w.y * t[P - b].x;
      e.y += w.y * t[P - b].y;
    }
    emit(j, make_float2(c.x - e.y, c.y + e.x));      // c + i e
    emit(P - j, make_float2(c.x + e.y, c.y - e.x));  // c - i e
  }
}

// The radix-R DFT of t in place, R in {2, 3, 4, 5, 8}. An odd prime from 7
// is always a line's last radix (first_radix takes the smallest prime
// first, and no line of the forms has two primes from 7), which
// lane_dft_emit hands over as prime_emit forms it.
template <int R>
__device__ __forceinline__ void radix_dft(float2 (&t)[R], bool inv) {
  static_assert(R == 2 || R == 3 || R == 4 || R == 5 || R == 8,
                "an odd prime from 7 runs in lane_dft_emit");
  if constexpr (R == 3)
    dft3(t, inv);
  else if constexpr (R == 5)
    dft5(t, inv);
  else
    butterfly<R>(t, inv);
}

// Index in its line of register r after lane_dft<N>: N = A B with A =
// first_radix(N); register b + B a ends holding X[a + A out_B(b)].
template <int N>
__host__ __device__ constexpr int lane_out(int r) {
  if constexpr (N == 1) {
    return 0;
  } else {
    constexpr int A = first_radix(N), B = N / A;
    return r / B + A * lane_out<B>(r % B);
  }
}

// The first radix of lane_dft<N> over x[kOff + kS i], i < N, in place:
// radix-A butterflies over x[b + B a] for each b, each value times W_N^(a
// b) = table[pad(a b kTab)] (the staged n-table, kTab = n / N).
template <int N, int kTab, int kOff, int kS, int M>
__device__ __forceinline__ void first_stage(float2 (&x)[M],
                                            const float2* table, bool inv) {
  constexpr int A = first_radix(N), B = N / A;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float2 t[A];
#pragma unroll
    for (int a = 0; a < A; ++a) t[a] = x[kOff + kS * (b + B * a)];
    radix_dft<A>(t, inv);
#pragma unroll
    for (int a = 0; a < A; ++a)
      x[kOff + kS * (b + B * a)] =
          a * b == 0 ? t[a] : cmul(t[a], table[pad(a * b * kTab)]);
  }
}

template <int N, int kTab, int kOff, int kS, int M>
__device__ __forceinline__ void lane_dft(float2 (&x)[M], const float2* table,
                                         bool inv);

template <int B, int kTab, int kOff, int kS, int M, int... a>
__device__ __forceinline__ void lane_subs(float2 (&x)[M], const float2* table,
                                          bool inv,
                                          std::integer_sequence<int, a...>) {
  (lane_dft<B, kTab, kOff + kS * B * a, kS>(x, table, inv), ...);
}

// The DFT of the N values x[kOff + kS i], i < N, in place in registers:
// the first radix (first_stage), then the B-long sub-lines a. Register i
// ends holding X[lane_out<N>(i)]. N's primes are 2, 3 and 5 (a line with
// a prime from 7 runs lane_dft_emit).
template <int N, int kTab, int kOff, int kS, int M>
__device__ __forceinline__ void lane_dft(float2 (&x)[M], const float2* table,
                                         bool inv) {
  constexpr int A = first_radix(N), B = N / A;
  first_stage<N, kTab, kOff, kS>(x, table, inv);
  if constexpr (B > 1)
    lane_subs<B, kTab * A, kOff, kS>(x, table, inv,
                                     std::make_integer_sequence<int, A>{});
}

template <int N, int kTab, int kOff, int kS, int M, typename Emit>
__device__ __forceinline__ void lane_dft_emit(float2 (&x)[M],
                                              const float2* table, bool inv,
                                              const Emit& emit);

// Sub-line a's consumer: its output q is the line's X[a + A q].
template <int A, int a, typename Emit>
struct SubEmit {
  const Emit& emit;
  __device__ __forceinline__ void operator()(int q, float2 v) const {
    emit(a + A * q, v);
  }
};

template <int B, int kTab, int A, int kOff, int kS, int M, typename Emit,
          int... a>
__device__ __forceinline__ void emit_subs(float2 (&x)[M], const float2* table,
                                          bool inv, const Emit& emit,
                                          std::integer_sequence<int, a...>) {
  (lane_dft_emit<B, kTab, kOff + kS * B * a, kS>(
       x, table, inv, SubEmit<A, a, Emit>{emit}),
   ...);
}

// lane_dft with the outputs handed over instead of kept: emit(k, X[k])
// once for each k < N (the registers are clobbered). The last radix of
// each sub-line hands its outputs over as it forms them (prime_emit for an
// odd prime from 7, else after its butterfly).
template <int N, int kTab, int kOff, int kS, int M, typename Emit>
__device__ __forceinline__ void lane_dft_emit(float2 (&x)[M],
                                              const float2* table, bool inv,
                                              const Emit& emit) {
  constexpr int A = first_radix(N), B = N / A;
  if constexpr (B == 1) {
    float2 t[A];
#pragma unroll
    for (int a = 0; a < A; ++a) t[a] = x[kOff + kS * a];
    if constexpr (A % 2 == 1 && A >= 7) {
      prime_emit<A, kTab>(t, table, emit);
    } else {
      radix_dft<A>(t, inv);
#pragma unroll
      for (int a = 0; a < A; ++a) emit(a, t[a]);
    }
  } else {
    first_stage<N, kTab, kOff, kS>(x, table, inv);
    emit_subs<B, kTab * A, A, kOff, kS>(x, table, inv, emit,
                                        std::make_integer_sequence<int, A>{});
  }
}

// A line of 2M on two lanes of a warp, t and t ^ 16 (p = bit 4 of the
// lane): lane p holds x[p + 2 i] in register i and transforms its half
// (F_p); the pair swaps M / 2 values by __shfl_xor_sync, so that lane p
// holds F_0[k] and F_1[k] for the k of its registers p M/2 .. p M/2 + M/2
// - 1, and forms X[k] = F_0 + W_2M^k F_1 in register i, X[k + M] = F_0 -
// W_2M^k F_1 in register M/2 + i (W_2M^k = table[pad(k kTab)]). Register
// r ends holding X[pair_out<M>(p, r)]. M is even; every lane of the warp
// must call it.
template <int M>
__host__ __device__ constexpr int pair_out(int p, int r) {
  return lane_out<M>(r % (M / 2) + (M / 2) * p) + M * (r / (M / 2));
}

template <int M, int kTab>
__device__ __forceinline__ void pair_dft(float2 (&v)[M], int p,
                                         const float2* table, bool inv) {
  static_assert(M % 2 == 0, "a pair swaps half its values");
  constexpr int H = M / 2;
  lane_dft<M, 2 * kTab, 0, 1>(v, table, inv);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float2 send = p ? v[i] : v[H + i];
    float2 got;
    got.x = __shfl_xor_sync(0xffffffffu, send.x, 16);
    got.y = __shfl_xor_sync(0xffffffffu, send.y, 16);
    const float2 a = p ? got : v[i];
    const float2 b = cmul(p ? v[H + i] : got,
                          table[pad((p ? lane_out<M>(H + i) : lane_out<M>(i)) *
                                    kTab)]);
    v[i] = cadd(a, b);
    v[H + i] = csub(a, b);
  }
}

}  // namespace tpufft_lane
