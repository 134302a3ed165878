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
// into shared memory, runs every Stockham stage there (fft_stages.cuh,
// shared with the strided-axis and pair kernels), and stores the rows
// coalesced in natural order. The TPU kernel's dense DFT matmuls and
// batch-on-lanes transposes exist for the MXU and are not carried over.
// The same kernel on fused storage (kFused) replaces _build_minor_fused
// (K20), whose block-complex matmul st @ [[Wr, Wi], [-Wi, Wr]] is this DFT
// of each row's two halves.
//
// Two details keep the passes near the bandwidth bound:
// - the load and the store are unrolled over a thread's kPer values, so
//   each thread has 2 kPer device-memory requests in flight;
// - rows of n <= 4096 are packed ~4096 elements to a block of up to 512
//   threads with kPer = 8, and __launch_bounds__(512, 2) holds registers
//   to 64 so that two such blocks share an SM (a block that keeps more
//   registers than that runs alone on its SM, with nothing to overlap its
//   load with; longer rows take one block of n/16 threads with kPer = 16).

#pragma once

#include "fft_stages.cuh"

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

}  // namespace tpufft_minor
