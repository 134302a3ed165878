// Device code of the batched minor-axis C2C FFT (see minor_fft.cu).
//
// Replaces tpufft/kernels/mxu_fft.py:_build_minor (the Pallas TPU kernel
// behind every contiguous minor-axis transform). Contract, as there:
// (batch, n) split re/im planes stored in f32 or bf16 -> the (batch, n)
// DFT in natural order, in the same storage dtype; f32 arithmetic; a
// forward/inverse flag; one real scale applied once, at the store.
//
// What bounds it on an H100: device-memory bandwidth. A pass reads and
// writes each complex element once (16 bytes in f32) against ~5 log2(n)
// flops, about 3 flop/byte at n = 1024, far below the card's
// compute/bandwidth ratio. The design therefore touches device memory
// exactly once each way: a block loads whole rows with coalesced reads
// into shared memory, runs every Stockham stage there, and stores the
// rows coalesced in natural order. The TPU kernel's dense DFT matmuls
// and batch-on-lanes transposes exist for the MXU and are not carried over.
//
// Stage math (the Stockham autosort of tpufft/planner.py): stage t with
// radix r and cumulative product s views a row as (r, m, s), m = n/(r s):
//
//     out[p, j, q] = w^(j p s) * sum_b W_r[j, b] * in[b, p, q]
//
// with w = exp(-+2 pi i / n), in at b*m*s + p*s + q, out at p*r*s + j*s + q.
// Radix 2/4/8 stages use the exact butterflies of mxu_fft.py:_butterfly
// (plus/minus i as plane swaps, 1/sqrt2 the only irrational constant);
// any other radix (an odd prime up to 127) sums its terms directly, in
// conjugate pairs (stage_odd).
// Every twiddle, W_r included (W_r^k = w^(k n / r)), comes from one
// host-f64 table of w^k, k < n, cast to f32 - no device trig.
//
// The stages run in place in ONE shared buffer (n = 16384 in f32 is
// 128 KB; a ping-pong pair would not fit in 227 KB): each thread computes
// its share of a stage into registers, the block synchronizes, and the
// registers are written back. The share, kPer complex values, fixes
// rows * n <= kPer * blockDim.x.
//
// Three details keep the passes near the bandwidth bound:
// - the load and the store are unrolled over a thread's kPer values, so
//   each thread has 2 kPer device-memory requests in flight;
// - rows of n <= 4096 are packed ~4096 elements to a block of up to 512
//   threads with kPer = 8, and __launch_bounds__(512, 2) holds registers
//   to 64 so that two such blocks share an SM (a block that keeps more
//   registers than that runs alone on its SM, with nothing to overlap its
//   load with; longer rows take one block of n/16 threads with kPer = 16);
// - shared memory is indexed through pad(i) = i + i/16, one spare float2
//   per 16: a radix-R stage with s = 1 writes with stride R, which would
//   put a half-warp's 16 float2 stores on 16/R of the 16 bank pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpufft_minor {

constexpr int kMaxN = 16384;
constexpr int kMaxStages = 32;
constexpr int kPackedElems = 4096;  // rows * n of a block of short rows

__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

struct Radices {
  int n;
  int count;
  int r[kMaxStages];
};

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// * -i (forward) / * +i (inverse)
__device__ __forceinline__ float2 mul_i(float2 a, bool inv) {
  return inv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// * exp(-+i pi/4)
__device__ __forceinline__ float2 mul_w8(float2 a, bool inv) {
  const float h = 0.70710678118654752f;
  return inv ? make_float2(h * (a.x - a.y), h * (a.y + a.x))
             : make_float2(h * (a.x + a.y), h * (a.y - a.x));
}
// * exp(-+3i pi/4)
__device__ __forceinline__ float2 mul_w83(float2 a, bool inv) {
  const float h = 0.70710678118654752f;
  return inv ? make_float2(h * (-a.x - a.y), h * (a.x - a.y))
             : make_float2(h * (a.y - a.x), h * (-a.x - a.y));
}

// In-register radix-R DFT, x[j] <- sum_b x[b] W_R^(j b); R in {2, 4, 8}.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&x)[R], bool inv);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&x)[2], bool) {
  const float2 a = x[0], b = x[1];
  x[0] = cadd(a, b);
  x[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&x)[4], bool inv) {
  const float2 t0 = cadd(x[0], x[2]), t1 = csub(x[0], x[2]);
  const float2 t2 = cadd(x[1], x[3]), t3 = csub(x[1], x[3]);
  const float2 it3 = mul_i(t3, inv);
  x[0] = cadd(t0, t2);
  x[1] = cadd(t1, it3);
  x[2] = csub(t0, t2);
  x[3] = csub(t1, it3);
}

template <>
__device__ __forceinline__ void butterfly<8>(float2 (&x)[8], bool inv) {
  const float2 a0 = cadd(x[0], x[4]), a1 = csub(x[0], x[4]);
  const float2 a2 = cadd(x[2], x[6]), a3 = csub(x[2], x[6]);
  const float2 a4 = cadd(x[1], x[5]), a5 = csub(x[1], x[5]);
  const float2 a6 = cadd(x[3], x[7]), a7 = csub(x[3], x[7]);
  const float2 b0 = cadd(a0, a2), b1 = csub(a0, a2);
  const float2 b2 = cadd(a4, a6), b3 = csub(a4, a6);
  const float2 ib3 = mul_i(b3, inv);
  const float2 ia3 = mul_i(a3, inv);
  const float2 c1 = cadd(a1, ia3), c2 = csub(a1, ia3);
  const float2 ia7 = mul_i(a7, inv);
  const float2 d1 = cadd(a5, ia7), d2 = csub(a5, ia7);
  const float2 e1 = mul_w8(d1, inv), e2 = mul_w83(d2, inv);
  x[0] = cadd(b0, b2);
  x[4] = csub(b0, b2);
  x[2] = cadd(b1, ib3);
  x[6] = csub(b1, ib3);
  x[1] = cadd(c1, e1);
  x[5] = csub(c1, e1);
  x[3] = cadd(c2, e2);
  x[7] = csub(c2, e2);
}

// One radix-R stage (R in {2, 4, 8}) over `rows` rows of length n held in
// buf; s is the product of the radices of the earlier stages.
template <int R, int kPer>
__device__ void stage_pow2(float2* buf, const float2* __restrict__ tw, int n,
                           int s, int rows, bool inv) {
  constexpr int K = kPer / R;
  const int m = n / (R * s);
  const int per_row = n / R;  // butterflies per row
  const int items = rows * per_row;
  float2 v[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    if (it < items) {
      const int row = it / per_row, bf = it - row * per_row;
      const int p = bf / s, q = bf - p * s;
      const int src = row * n + p * s + q;
#pragma unroll
      for (int b = 0; b < R; ++b) v[k][b] = buf[pad(src + b * m * s)];
      butterfly<R>(v[k], inv);
#pragma unroll
      for (int j = 1; j < R; ++j) v[k][j] = cmul(v[k][j], __ldg(&tw[j * p * s]));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    if (it < items) {
      const int row = it / per_row, bf = it - row * per_row;
      const int p = bf / s, q = bf - p * s;
      const int dst = row * n + p * R * s + q;
#pragma unroll
      for (int j = 0; j < R; ++j) buf[pad(dst + j * s)] = v[k][j];
    }
  }
  __syncthreads();
}

// One stage of an odd radix r (a prime up to 127). With h = (r - 1) / 2,
// x_b w^(jb) + x_(r-b) w^(-jb) = (x_b + x_(r-b)) c + i (x_b - x_(r-b)) s for
// w^(jb) = c + i s, so outputs j and r - j share their h terms:
//   out[j], out[r-j] = x_0 + A +- i D,  A = sum_b a_b c_jb,  D = sum_b d_b s_jb
// (a_b, d_b the sum and difference of x_b and x_(r-b)), each then times its
// twiddle w^(j p s). Item jj = 0 of a (row, p, q) group computes out[0],
// item jj >= 1 the pair (jj, r - jj); consecutive threads take consecutive
// groups, so their reads are consecutive and their writes odd-strided
// (conflict-free). A thread holds at most ceil(kPer (r+1) / 2r) <=
// ceil(2 kPer / 3) items of two values each.
template <int kPer>
__device__ void stage_odd(float2* buf, const float2* __restrict__ tw, int n,
                          int r, int s, int rows) {
  constexpr int K = (2 * kPer + 2) / 3;
  const int h = (r - 1) / 2;
  const int stride = n / r;  // m * s: distance between the r inputs
  const int groups = rows * stride;
  const int items = groups * (h + 1);
  float2 v0[K], v1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    if (it < items) {
      const int jj = it / groups, g = it - jj * groups;
      const int row = g / stride, rem = g - row * stride;
      const int p = rem / s, q = rem - p * s;
      const int src = row * n + p * s + q;
      const float2 x0 = buf[pad(src)];
      if (jj == 0) {
        float2 acc = x0;
        for (int b = 1; b < r; ++b) acc = cadd(acc, buf[pad(src + b * stride)]);
        v0[k] = acc;
      } else {
        float2 A = make_float2(0.f, 0.f), D = make_float2(0.f, 0.f);
        int e = 0;  // (jj * b) mod r
        for (int b = 1; b <= h; ++b) {
          e += jj;
          if (e >= r) e -= r;
          const float2 w = __ldg(&tw[e * stride]);
          const float2 xb = buf[pad(src + b * stride)];
          const float2 xc = buf[pad(src + (r - b) * stride)];
          A.x += (xb.x + xc.x) * w.x;
          A.y += (xb.y + xc.y) * w.x;
          D.x += (xb.x - xc.x) * w.y;
          D.y += (xb.y - xc.y) * w.y;
        }
        const float2 o1 = make_float2(x0.x + A.x - D.y, x0.y + A.y + D.x);
        const float2 o2 = make_float2(x0.x + A.x + D.y, x0.y + A.y - D.x);
        v0[k] = cmul(o1, __ldg(&tw[jj * p * s]));
        v1[k] = cmul(o2, __ldg(&tw[(r - jj) * p * s]));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    if (it < items) {
      const int jj = it / groups, g = it - jj * groups;
      const int row = g / stride, rem = g - row * stride;
      const int p = rem / s, q = rem - p * s;
      const int dst = row * n + p * r * s + q;
      buf[pad(dst + jj * s)] = v0[k];
      if (jj) buf[pad(dst + (r - jj) * s)] = v1[k];
    }
  }
  __syncthreads();
}

// Block b transforms rows [b*rows, b*rows + rows) of the (batch, n) planes;
// the ragged last block computes on zero rows and stores only real ones.
// blockDim.x <= kThreads and rows * n <= kPer * blockDim.x.
template <typename T, int kThreads, int kPer, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
minor_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ yr, T* __restrict__ yi,
                 const float2* __restrict__ tw, int64_t batch, Radices plan,
                 int rows, int inverse, float scale) {
  extern __shared__ float2 tpufft_minor_smem[];
  float2* buf = tpufft_minor_smem;
  const int n = plan.n;
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
    if (e < valid) v[k] = make_float2(load_f(xr, base + e), load_f(xi, base + e));
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) buf[pad(e)] = v[k];
  }
  __syncthreads();
  const bool inv = inverse != 0;
  int s = 1;
  for (int t = 0; t < plan.count; ++t) {
    const int r = plan.r[t];
    switch (r) {
      case 8: stage_pow2<8, kPer>(buf, tw, n, s, rows, inv); break;
      case 4: stage_pow2<4, kPer>(buf, tw, n, s, rows, inv); break;
      case 2: stage_pow2<2, kPer>(buf, tw, n, s, rows, inv); break;
      default: stage_odd<kPer>(buf, tw, n, r, s, rows); break;
    }
    s *= r;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < valid) {
      const float2 w = buf[pad(e)];
      store_f(yr, base + e, w.x * scale);
      store_f(yi, base + e, w.y * scale);
    }
  }
}

// Launch geometry for length n: rows per block, values per thread (the
// kernel's kPer), threads per block, and dynamic shared memory in bytes.
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

}  // namespace tpufft_minor
