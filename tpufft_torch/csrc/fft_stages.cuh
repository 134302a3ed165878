// The in-shared-memory Stockham FFT core shared by the port's C2C kernels:
// the minor-axis kernel (minor_fft.cuh), the strided-axis kernel
// (strided_fft.cu), the trailing-pair kernel (pair_fft.cu), the cluster
// kernels (cluster_fft.cu) and the real transforms (real_fft.cu). Each kernel
// loads its tile from device memory into one shared buffer laid out as
// `rows` rows of length n, calls run_stages, and stores the rows back; only
// the load and the store differ between them.
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
// Shared memory is indexed through pad(i) = i + i/16, one spare float2
// per 16: a radix-R stage with s = 1 writes with stride R, which would
// put a half-warp's 16 float2 stores on 16/R of the 16 bank pairs.
//
// Fused storage (tpufft's layout="lane-fused" plans): a logical complex
// row of length h is one real row of 2h, [re(0..h-1) | im(0..h-1)]. Each
// kernel reads and writes it through its two plane pointers, set by the
// host to st and st + h, at fused_index(g, g mod h) for logical element g:
// re at st[2g - g mod h], im h further on. The two pointers address
// disjoint elements of one buffer, so their __restrict__ holds. A kernel
// takes the layout as a template flag (kFused); with it off, its loads and
// stores are the split planes' own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpufft_fft {

constexpr int kMaxN = 16384;
constexpr int kMaxStages = 32;

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
// buf; s is the product of the radices of the earlier stages. Where n is
// a power of two (so are per_row and s), the item's row and butterfly come
// from shifts and masks instead of integer division (a few instructions
// against ~20).
template <int R, int kPer>
__device__ void stage_pow2(float2* buf, const float2* __restrict__ tw, int n,
                           int s, int rows, bool inv) {
  constexpr int K = kPer / R;
  const int m = n / (R * s);
  const int per_row = n / R;  // butterflies per row
  const int items = rows * per_row;
  const bool shift = (n & (n - 1)) == 0;
  const int l_row = __ffs(per_row) - 1, l_s = __ffs(s) - 1;  // for shift
  // item it -> (row, p, q): it = row * per_row + p * s + q
  const auto split = [&](int it, int& row, int& p, int& q) {
    if (shift) {
      row = it >> l_row;
      const int bf = it & (per_row - 1);
      p = bf >> l_s;
      q = bf & (s - 1);
    } else {
      row = it / per_row;
      const int bf = it - row * per_row;
      p = bf / s;
      q = bf - p * s;
    }
  };
  float2 v[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    if (it < items) {
      int row, p, q;
      split(it, row, p, q);
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
      int row, p, q;
      split(it, row, p, q);
      const int dst = row * n + p * R * s + q;
#pragma unroll
      for (int j = 0; j < R; ++j) buf[pad(dst + j * s)] = v[k][j];
    }
  }
  __syncthreads();
}

// Output 0 of a radix-r DFT (r odd) whose inputs are at(b), b < r, and
// x0 = at(0): their sum.
template <class At>
__device__ __forceinline__ float2 odd_sum(const At& at, float2 x0, int r) {
  float2 acc = x0;
  for (int b = 1; b < r; ++b) acc = cadd(acc, at(b));
  return acc;
}

// Outputs jj and r - jj (1 <= jj <= (r - 1) / 2) of that DFT, before any
// stage twiddle, into o1 and o2, with W_r^e = tw[e * stride] (the conjugate
// pairs of stage_odd below).
template <class At>
__device__ __forceinline__ void odd_pair(const At& at, float2 x0,
                                         const float2* __restrict__ tw, int r,
                                         int stride, int jj, float2& o1,
                                         float2& o2) {
  const int h = (r - 1) / 2;
  float2 A = make_float2(0.f, 0.f), D = make_float2(0.f, 0.f);
  int e = 0;  // (jj * b) mod r
  for (int b = 1; b <= h; ++b) {
    e += jj;
    if (e >= r) e -= r;
    const float2 w = __ldg(&tw[e * stride]);
    const float2 xb = at(b);
    const float2 xc = at(r - b);
    A.x += (xb.x + xc.x) * w.x;
    A.y += (xb.y + xc.y) * w.x;
    D.x += (xb.x - xc.x) * w.y;
    D.y += (xb.y - xc.y) * w.y;
  }
  o1 = make_float2(x0.x + A.x - D.y, x0.y + A.y + D.x);
  o2 = make_float2(x0.x + A.x + D.y, x0.y + A.y - D.x);
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
      const auto at = [&](int b) { return buf[pad(src + b * stride)]; };
      const float2 x0 = at(0);
      if (jj == 0) {
        v0[k] = odd_sum(at, x0, r);
      } else {
        float2 o1, o2;
        odd_pair(at, x0, tw, r, stride, jj, o1, o2);
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

// Every stage of `plan` over `rows` rows of length plan.n in buf, which
// the caller has filled and synchronized; the DFT of each row ends in
// buf in natural order, synchronized.
template <int kPer>
__device__ __forceinline__ void run_stages(float2* buf,
                                           const float2* __restrict__ tw,
                                           const Radices& plan, int rows,
                                           bool inv) {
  const int n = plan.n;
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
}

// e / d for 0 <= e < 2^16 and 1 <= d < 2^16 as a multiply and a shift:
// with m = ceil(2^32 / d), e m / 2^32 = e / d + e (m - 2^32 / d) / 2^32,
// and the second term is below 2^-16 < 1/d, so the floor is exact. The
// kernels' in-block indices are below 16384, where a hardware division
// costs ~20 instructions and would run for every element of every phase.
struct Div {
  unsigned long long m;
  __device__ __forceinline__ explicit Div(int d)
      : m(((1ull << 32) + (unsigned)d - 1) / (unsigned)d) {}
  __device__ __forceinline__ int operator()(int e) const {
    return (int)(((unsigned long long)(unsigned)e * m) >> 32);
  }
};

// Index, through the re pointer, of logical element g of fused storage;
// k = g mod h (the im value lies h further on).
__device__ __forceinline__ int64_t fused_index(int64_t g, int k) {
  return 2 * g - k;
}

// Host: fill `plan` from radices[0:nstages] for length n; false unless
// each radix is 2, 4, 8 or an odd value up to 127 and they multiply to n.
inline bool make_radices(int n, const int* radices, int nstages,
                         Radices* plan) {
  if (n < 1 || n > kMaxN || nstages < 0 || nstages > kMaxStages) return false;
  long long prod = 1;
  plan->n = n;
  plan->count = nstages;
  for (int i = 0; i < nstages; ++i) {
    const int r = radices[i];
    if (r < 2 || r > 127 || (r % 2 == 0 && r != 2 && r != 4 && r != 8))
      return false;
    plan->r[i] = r;
    prod *= r;
  }
  return prod == n;
}

// Host: let `kernel` take `bytes` of dynamic shared memory (above 48 KB a
// kernel must opt in).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Host: the launch configuration of `kernel` for `blocks` blocks of
// `threads` threads and `smem` bytes of dynamic shared memory in clusters
// of csize, with the kernel's attributes set (dynamic shared memory above
// 48 KB; a cluster of 16, above the portable 8). The cluster kernels'
// (cluster_fft.cu, strided_long.cuh).
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int threads, size_t smem,
                           long long blocks, int csize, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)blocks);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace tpufft_fft
