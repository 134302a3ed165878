// Batched 2-D C2C FFT over the two trailing axes of (pre, n1, n2) planes,
// with plain C entry points for ctypes (tpufft_torch/kernels/pair_fft.py
// and fused_fft.py bind and check them).
//
// Replaces tpufft/kernels/mxu_fft.py:_build_2d, the Pallas TPU kernel that
// runs a plan's trailing pair of axes in one pass, and, on fused storage
// (tpufft_pair_fft_fused: (pre, n1, 2*n2), each n2-row [re | im]; only the
// load and the store differ), _build_pair_fused (K17). Contract as there: f32
// or bf16 storage, f32 arithmetic, a forward/inverse flag, one real scale
// applied once at the store, and n2_io's zero-pad direction (m_in < m_out =
// n2) as n2_in: the input slices are (n1, n2_in) and their columns n2_in..
// n2-1 load as zeros, so the pad never touches device memory. n2_io's crop
// direction (the adjoint) is not a forward path here: the backward of the
// padded pair is the full pair of the gradient, then a crop.
//
// What bounds it on an H100: device-memory bandwidth (~3 flop/byte per
// axis). Run axis by axis, a 2-D transform reads and writes the planes
// twice; this kernel does it once. A block loads whole (n1, n2) slices
// (contiguous, so the load is K1's coalesced row load), runs the n2
// transforms of the n1 rows with the shared Stockham stages
// (fft_stages.cuh), transposes each slice in shared memory through
// registers to (n2, n1), runs the n1 transforms of the n2 rows, and
// stores each element back to its natural (k1, k2) place. The slices are
// packed like the minor kernel's rows (minor_fft.cuh:launch_geometry):
// ~4096 elements to a 512-thread block, or one slice of up to 16384
// elements (139 KB of shared memory) to a block of up to 1024 threads.
//
// Known cost left for later work: the transpose and the store read or
// write shared memory with stride n1, which puts up to 16 threads of a
// half-warp on one bank when n1 is a multiple of 16.

#include <climits>

#include "minor_fft.cuh"

using namespace tpufft_fft;
using tpufft_minor::Geometry;
using tpufft_minor::launch_geometry;

namespace {

// Block b transforms slices [b*slabs, b*slabs + slabs) of the planes; the
// ragged last block computes on zero slices and stores only real ones.
// kPadded: input slices are (n1, n2_in), zero-padded to (n1, n2) at the
// load; without it n2_in is unused. kFused (K17): the slices are fused
// storage, h = n2 (fft_stages.cuh).
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi,
                const float2* __restrict__ tw1,
                const float2* __restrict__ tw2, int64_t pre, Radices plan1,
                Radices plan2, int slabs, int n2_in, int inverse,
                float scale) {
  static_assert(!(kPadded && kFused), "no fused zero-pad form");
  extern __shared__ float2 tpufft_pair_smem[];
  float2* buf = tpufft_pair_smem;
  const int n1 = plan1.n, n2 = plan2.n, area = n1 * n2;
  const int64_t s0 = (int64_t)blockIdx.x * slabs;
  const int64_t here = pre - s0 < slabs ? pre - s0 : slabs;
  const int64_t base = s0 * area;
  const int total = slabs * area;
  const int valid = (int)(here * area);
  const bool inv = inverse != 0;
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.f, 0.f);
    if (kPadded) {
      const int r = e / n2, c = e - r * n2;  // r = slice * n1 + k1
      const int64_t src = (s0 * n1 + r) * n2_in + c;
      if (e < valid && c < n2_in)
        v[k] = make_float2(load_f(xr, src), load_f(xi, src));
    } else if (e < valid) {
      const int64_t g = kFused ? fused_index(base + e, e % n2) : base + e;
      v[k] = make_float2(load_f(xr, g), load_f(xi, g));
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) buf[pad(e)] = v[k];
  }
  __syncthreads();
  run_stages<kPer>(buf, tw2, plan2, slabs * n1, inv);  // along n2
  // (n1, n2) -> (n2, n1) in every slice, in place through registers
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) v[k] = buf[pad(e)];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) {
      const int s = e / area, r = e - s * area;
      const int k1 = r / n2, k2 = r - k1 * n2;
      buf[pad(s * area + k2 * n1 + k1)] = v[k];
    }
  }
  __syncthreads();
  run_stages<kPer>(buf, tw1, plan1, slabs * n2, inv);  // along n1
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < valid) {
      const int s = e / area, r = e - s * area;
      const int k1 = r / n2, k2 = r - k1 * n2;
      const float2 w = buf[pad(s * area + k2 * n1 + k1)];
      const int64_t g = kFused ? fused_index(base + e, k2) : base + e;
      store_f(yr, g, w.x * scale);
      store_f(yi, g, w.y * scale);
    }
  }
}

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused>
int launch(const void* xr, const void* xi, void* yr, void* yi,
           const void* tw1, const void* tw2, long long pre,
           const Radices& plan1, const Radices& plan2, const Geometry& g,
           int n2_in, int inverse, float scale, cudaStream_t stream) {
  auto* kernel =
      pair_fft_kernel<T, kThreads, kPer, kMinBlocks, kPadded, kFused>;
  if (g.threads > kThreads || g.per != kPer) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (pre + g.rows - 1) / g.rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, g.threads, g.smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(yr), static_cast<T*>(yi),
      static_cast<const float2*>(tw1), static_cast<const float2*>(tw2),
      (int64_t)pre, plan1, plan2, g.rows, n2_in, inverse, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kPadded, bool kFused>
int launch_sized(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw1, const void* tw2, long long pre,
                 const Radices& plan1, const Radices& plan2, int n2_in,
                 int inverse, float scale, cudaStream_t stream) {
  const Geometry g = launch_geometry(plan1.n * plan2.n);
  if (g.per == 8)
    return launch<T, 512, 8, 2, kPadded, kFused>(xr, xi, yr, yi, tw1, tw2,
                                                  pre, plan1, plan2, g, n2_in,
                                                  inverse, scale, stream);
  return launch<T, 1024, 16, 1, kPadded, kFused>(xr, xi, yr, yi, tw1, tw2,
                                                 pre, plan1, plan2, g, n2_in,
                                                 inverse, scale, stream);
}

template <typename T>
int launch_typed(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw1, const void* tw2, long long pre,
                 const Radices& plan1, const Radices& plan2, int n2_in,
                 int inverse, float scale, cudaStream_t stream) {
  if (n2_in == plan2.n)
    return launch_sized<T, false, false>(xr, xi, yr, yi, tw1, tw2, pre,
                                         plan1, plan2, n2_in, inverse, scale,
                                         stream);
  return launch_sized<T, true, false>(xr, xi, yr, yi, tw1, tw2, pre, plan1,
                                      plan2, n2_in, inverse, scale, stream);
}

// K17: (pre, n1, 2*n2) fused storage, its two planes st and st + n2 (out
// and out + n2) with row stride 2*n2.
template <typename T>
int launch_fused(const void* st, void* out, const void* tw1, const void* tw2,
                 long long pre, const Radices& plan1, const Radices& plan2,
                 int inverse, float scale, cudaStream_t stream) {
  const T* x = static_cast<const T*>(st);
  T* y = static_cast<T*>(out);
  const int n2 = plan2.n;
  return launch_sized<T, false, true>(x, x + n2, y, y + n2, tw1, tw2, pre,
                                      plan1, plan2, n2, inverse, scale,
                                      stream);
}

}  // namespace

// Transforms both trailing axes of the (pre, n1, n2_in) planes xr/xi,
// zero-padded along the last axis to n2, into the (pre, n1, n2) planes
// yr/yi (f32, or bf16 when bf16 != 0) on `stream`, a stream of the current
// device; n2_in == n2 is the plain pair transform. tw1 and tw2 hold
// exp(-+2 pi i k / n1) and exp(-+2 pi i k / n2) as complex f32 for the
// direction; rad1 and rad2 multiply to n1 and n2, each radix 2, 4, 8 or an
// odd value up to 127; n1, n2 >= 2, 1 <= n2_in <= n2 and n1 * n2 <= 16384.
// Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_pair_fft(const void* xr, const void* xi, void* yr,
                               void* yi, const void* tw1, const void* tw2,
                               long long pre, int n1, int n2, int n2_in,
                               const int* rad1, int nstages1,
                               const int* rad2, int nstages2, int inverse,
                               float scale, int bf16, void* stream) {
  Radices plan1, plan2;
  if (pre < 0 || n1 < 2 || n2 < 2 || (long long)n1 * n2 > kMaxN ||
      n2_in < 1 || n2_in > n2 ||
      !make_radices(n1, rad1, nstages1, &plan1) ||
      !make_radices(n2, rad2, nstages2, &plan2))
    return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(xr, xi, yr, yi, tw1, tw2, pre, plan1,
                                       plan2, n2_in, inverse, scale, s);
  return launch_typed<float>(xr, xi, yr, yi, tw1, tw2, pre, plan1, plan2,
                             n2_in, inverse, scale, s);
}

// K17: both trailing logical axes of the (pre, n1, 2*n2) array st in fused
// storage, each n2-row [re(0..n2-1) | im(0..n2-1)], into `out` of the same
// shape; every other argument and condition as for tpufft_pair_fft with
// n2_in = n2. Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_pair_fft_fused(const void* st, void* out,
                                     const void* tw1, const void* tw2,
                                     long long pre, int n1, int n2,
                                     const int* rad1, int nstages1,
                                     const int* rad2, int nstages2,
                                     int inverse, float scale, int bf16,
                                     void* stream) {
  Radices plan1, plan2;
  if (pre < 0 || n1 < 2 || n2 < 2 || (long long)n1 * n2 > kMaxN ||
      !make_radices(n1, rad1, nstages1, &plan1) ||
      !make_radices(n2, rad2, nstages2, &plan2))
    return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fused<__nv_bfloat16>(st, out, tw1, tw2, pre, plan1, plan2,
                                       inverse, scale, s);
  return launch_fused<float>(st, out, tw1, tw2, pre, plan1, plan2, inverse,
                             scale, s);
}
