// Multi-axis C2C FFTs whose tile outgrows one block's shared memory, run on
// a thread-block cluster that holds the tile in distributed shared memory:
//
// - K5, tpufft_cube_fft: the three trailing axes of (pre, n1, n2, n3)
//   planes in one pass. Replaces tpufft/kernels/mxu_fft.py:_build_3d.
// - K6, tpufft_mid_pair_fft: axes 1 and 2 of (pre, n1, n2, L) planes in
//   one pass, L the contiguous batch (fftn(axes=(1, 2)) of a channels-last
//   (B, H, W, C) array). Replaces tpufft/kernels/mxu_fft.py:_build_mid_pair.
// - K16, tpufft_cube_fft_fused: K5 on fused storage (pre, n1, n2, 2*n3),
//   each n3-row [re | im] (fft_stages.cuh). Replaces
//   tpufft/kernels/mxu_fft.py:_build_3d_fused; only the load and the store
//   differ from K5, through the kernel's kFused flag.
//
// Contract as there: f32 or bf16 storage, f32 arithmetic, a forward/inverse
// flag, and one real scale applied once at the store. Plain C entry points
// for ctypes (tpufft_torch/kernels/cube_fft.py, mid_pair_fft.py and
// fused_fft.py bind and check them).
//
// What bounds them on an H100: device-memory bandwidth by the bytes (~3
// flop/byte an axis), but in practice the shared-memory passes and the
// barriers between them. Run axis by axis, a 3-D transform reads and
// writes the planes three times and a middle pair twice; these kernels do
// it once. A 64^3 c64 cube is 2 MiB and one block holds at most 227 KB, so
// the tile is split along n1 over a cluster of C blocks (C in 1, 2, 4, 8,
// 16; C = 16 is a non-portable cluster size, allowed per kernel), each
// holding at most 16384 elements (139 KB with the bank padding), K4's
// largest slice:
//
// 1. block b loads its n1/C slabs along n1 (for K5 one contiguous run;
//    for K6 rows of `lanes` contiguous elements, the ragged end of L
//    masked to zeros) and runs the trailing axes of each slab with the
//    shared Stockham stages (fft_stages.cuh): K5 runs n2, transposes each
//    slab back to natural (k2, k3) order and runs n3; K6 runs n2 along
//    rows (slab, lane);
// 2. cluster.sync(); block b then owns 1/C of the n1-columns (for K5 a
//    contiguous run of flat (k2, k3) positions, for K6 of flat
//    (k2, lane) positions) and gathers them, n1 values each, from the
//    cluster's shared memory (map_shared_rank) - the same count it holds;
// 3. cluster.sync() again, so that no block overwrites, or exits with,
//    memory another block still reads; the gathered values go to the
//    block's own shared memory as rows of n1, the n1 stages run, and each
//    k1 stores the block's columns as one run (K5: (n2 n3)/C contiguous
//    elements, 1 KB at 64^3 f32; K6: runs of `lanes` elements, 4 from
//    the wrapper).
//
// A thread holds at most 8 values in any phase (kPer = 8): at 1024 threads
// a block has 64 registers a thread, and 16 values spilled to memory. A
// block of more than 8192 elements so works in two register passes: the
// stages run in chunks of whole rows, and an in-place permutation or the
// gather parks its second pass in a spare shared region (70 KB at 16384).
// Every index is split by multiply-and-shift division (Div), not by the
// hardware's ~20-instruction integer division. The host picks C so that a
// block holds at most 2048 elements where it can (kernels/cube_fft.py:
// pick_cluster): small blocks share an SM, and one block's loads overlap
// another's stages.
//
// Known costs left for later work (PERF.md; tools/cluster_phases.py times
// each phase): a 64^3 cube needs C = 16 blocks of 16384, one block an SM,
// so its loads, barriers and stages overlap nothing, and 7 such clusters
// fit the H100 (112 of 132 SMs); the slab transpose, the n1-row writes and
// the store's reads are 4-way bank conflicts (the row pitch n + n/16 that
// keeps the stages conflict-free); the gather reads 15/16 of a 16-block
// tile from other SMs.

#include <climits>
#include <cooperative_groups.h>

#include "fft_stages.cuh"

namespace cg = cooperative_groups;
using namespace tpufft_fft;

namespace {

constexpr int kPer = 8;             // values a thread holds in any phase
constexpr int kPackedShare = 4096;  // shares up to this run 512 threads

// Block geometry for `share` elements a block: threads, elements one pass
// of kPer values a thread covers, and dynamic shared memory in bytes - the
// share, and when it takes two passes a spare region for the second pass
// of an in-place permutation or of the gather.
struct Shape {
  int threads, span;
  size_t smem;
};

inline Shape block_shape(int share) {
  Shape s;
  const int want = ((share + kPer - 1) / kPer + 31) / 32 * 32;
  s.threads = want < 1024 ? want : 1024;
  s.span = kPer * s.threads;
  const int spare = share > s.span ? pad(share - s.span) : 0;
  s.smem = (size_t)(pad(share) + spare) * sizeof(float2);
  return s;
}

// Rows of length n that one chunk of stages takes in a block of `threads`
// threads: whole rows of at most kPer values a thread, a multiple of 16
// elements, where pad(c + i) = pad(c) + pad(i); 0 when there is none.
__host__ __device__ inline int chunk_rows(int n, int threads) {
  const int low = n & -n;  // the largest power of two dividing n
  const int align = low >= 16 ? 1 : 16 / low;
  const int rows = kPer * threads / n;
  return rows - rows % align;
}

// Can `rows` rows of length n run their stages in a block of `threads`
// threads?
inline bool stages_fit(int n, int rows, int threads) {
  return (long long)rows * n <= (long long)kPer * threads ||
         chunk_rows(n, threads) > 0;
}

// Every stage of `plan` over `rows` rows of length plan.n in buf, in
// chunks of chunk_rows(n) rows when they are more than one pass of kPer
// values a thread (the host checks stages_fit).
__device__ __forceinline__ void stages(float2* buf,
                                       const float2* __restrict__ tw,
                                       const Radices& plan, int rows,
                                       bool inv) {
  const int n = plan.n;
  if (rows * n <= kPer * (int)blockDim.x) {
    run_stages<kPer>(buf, tw, plan, rows, inv);
    return;
  }
  const int chunk = chunk_rows(n, blockDim.x);
  for (int r0 = 0; r0 < rows; r0 += chunk)
    run_stages<kPer>(buf + pad(r0 * n), tw, plan,
                     rows - r0 < chunk ? rows - r0 : chunk, inv);
}

inline bool cluster_ok(int csize) {
  return csize == 1 || csize == 2 || csize == 4 || csize == 8 ||
         csize == 16;
}

// Element e of a share, in the register pass `h` of a thread's k-th value.
__device__ __forceinline__ int elem(int h, int k) {
  return (h * kPer + k) * (int)blockDim.x + threadIdx.x;
}

// Move element src(e) of buf to position dst(e), for every e < share, in
// place: destinations of the second pass are read into `spare` first, the
// first pass's into registers; then both are written (synchronized).
template <typename Src, typename Dst>
__device__ __forceinline__ void permute(float2* buf, float2* spare, int share,
                                        Src src, Dst dst) {
  const int span = kPer * blockDim.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(1, k);
    if (e < share) spare[pad(e - span)] = buf[pad(src(e))];
  }
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(0, k);
    if (e < share) v[k] = buf[pad(src(e))];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(0, k);
    if (e < share) buf[pad(dst(e))] = v[k];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(1, k);
    if (e < share) buf[pad(dst(e))] = spare[pad(e - span)];
  }
  __syncthreads();
}

// Gather element e of the n1-rows from the cluster's shared memory (remote
// returns its source: the block and the padded index there) into position
// dst(e) of buf. The first cluster.sync() makes every block's stages
// visible; the second keeps every block's memory in place until the whole
// cluster has read it.
template <typename Remote, typename Dst>
__device__ __forceinline__ void gather(cg::cluster_group& cluster,
                                       float2* buf, float2* spare, int share,
                                       Remote remote, Dst dst) {
  const int span = kPer * blockDim.x;
  cluster.sync();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(1, k);
    if (e < share) spare[pad(e - span)] = remote(e);
  }
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(0, k);
    if (e < share) v[k] = remote(e);
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(0, k);
    if (e < share) buf[pad(dst(e))] = v[k];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = elem(1, k);
    if (e < share) buf[pad(dst(e))] = spare[pad(e - span)];
  }
  __syncthreads();
}

// K5. Cluster c (blocks c*C .. c*C + C-1) transforms cube c; block `rank`
// holds slabs [rank*slabs, rank*slabs + slabs) of n1 and, after the
// gather, flat (k2, k3) columns [rank*cols, rank*cols + cols) as rows of
// n1. kFused (K16): the cube is fused storage (pre, n1, n2, 2*n3), h = n3
// (fft_stages.cuh); the block's slabs are then runs of n3 values a plane,
// each n3-row's re run followed by its im run.
template <typename T, int kThreads, int kMinBlocks, bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cube_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi,
                const float2* __restrict__ tw1,
                const float2* __restrict__ tw2,
                const float2* __restrict__ tw3, Radices plan1,
                Radices plan2, Radices plan3, int csize, int inverse,
                float scale) {
  extern __shared__ float2 tpufft_cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n1 = plan1.n, n2 = plan2.n, n3 = plan3.n;
  const int area = n2 * n3;
  const int slabs = n1 / csize;
  const int share = slabs * area;  // == n1 * cols
  const int cols = area / csize;
  float2* buf = tpufft_cluster_smem;
  float2* spare = buf + pad(share);
  const int rank = (int)cluster.block_rank();
  const int64_t base = (int64_t)(blockIdx.x / csize) * n1 * area;
  const bool inv = inverse != 0;
  const Div by_area(area), by_n2(n2), by_n3(n3), by_cols(cols),
      by_slabs(slabs);
  // load: the block's slabs are one contiguous run; each slab goes to
  // shared memory transposed, (n2, n3) -> (n3, n2), for the n2 stages
  const int64_t src0 = base + (int64_t)rank * share;
  for (int h = 0; h * kPer * (int)blockDim.x < share; ++h) {
    float2 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      if (e < share) {
        int64_t src = src0 + e;
        if (kFused) {
          const int r = e - by_area(e) * area;
          src = fused_index(src, r - by_n3(r) * n3);
        }
        v[k] = make_float2(load_f(xr, src), load_f(xi, src));
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      if (e < share) {
        const int j = by_area(e), r = e - j * area;
        const int k2 = by_n3(r), k3 = r - k2 * n3;
        buf[pad(j * area + k3 * n2 + k2)] = v[k];
      }
    }
  }
  __syncthreads();
  stages(buf, tw2, plan2, slabs * n3, inv);  // along n2
  // (n3, n2) -> (n2, n3) in every slab: natural element e comes from its
  // transposed place
  permute(
      buf, spare, share,
      [=](int e) {
        const int j = by_area(e), r = e - j * area;
        const int k2 = by_n3(r), k3 = r - k2 * n3;
        return j * area + k3 * n2 + k2;
      },
      [](int e) { return e; });
  stages(buf, tw3, plan3, slabs * n2, inv);  // along n3
  // gather the n1-columns [rank*cols, rank*cols + cols): element e is
  // (k1, q) = (e / cols, e % cols), held by block k1 / slabs in its slab
  // k1 % slabs at natural position rank*cols + q, and goes to n1-row q
  gather(
      cluster, buf, spare, share,
      [&](int e) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        const int owner = by_slabs(k1), j = k1 - owner * slabs;
        return cluster.map_shared_rank(buf, owner)[pad(
            j * area + rank * cols + q)];
      },
      [=](int e) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        return q * n1 + k1;
      });
  stages(buf, tw1, plan1, cols, inv);  // along n1
  const int64_t dst0 = base + (int64_t)rank * cols;
  for (int h = 0; h * kPer * (int)blockDim.x < share; ++h) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      if (e < share) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        const float2 w = buf[pad(q * n1 + k1)];
        int64_t dst = dst0 + (int64_t)k1 * area + q;
        if (kFused) {
          const int c = rank * cols + q;  // the flat (k2, k3) column
          dst = fused_index(dst, c - by_n3(c) * n3);
        }
        store_f(yr, dst, w.x * scale);
        store_f(yi, dst, w.y * scale);
      }
    }
  }
}

// K6. Cluster c transforms tile c = (plane p, lanes [l0, l0 + lanes)) of
// the (pre, n1, n2, L) planes; block `rank` holds rows k1 in
// [rank*slabs, rank*slabs + slabs) as shared rows (slab, lane) of n2 and,
// after the gather, flat (k2, lane) columns [rank*cols, rank*cols + cols)
// as rows of n1. Lanes at or past L load as zeros and are never stored.
template <typename T, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mid_pair_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                    T* __restrict__ yr, T* __restrict__ yi,
                    const float2* __restrict__ tw1,
                    const float2* __restrict__ tw2, Radices plan1,
                    Radices plan2, int64_t L, int lanes, int csize,
                    int inverse, float scale) {
  extern __shared__ float2 tpufft_cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n1 = plan1.n, n2 = plan2.n;
  const int slabs = n1 / csize;
  const int width = n2 * lanes;        // one k1 of the tile
  const int share = slabs * width;     // == n1 * cols
  const int cols = width / csize;
  float2* buf = tpufft_cluster_smem;
  float2* spare = buf + pad(share);
  const int rank = (int)cluster.block_rank();
  const int64_t tile = blockIdx.x / csize;
  const int64_t ltiles = (L + lanes - 1) / lanes;
  const int64_t p = tile / ltiles;
  const int64_t l0 = (tile - p * ltiles) * lanes;
  const int64_t plane = p * n1;        // row of k1 = 0
  const bool inv = inverse != 0;
  const Div by_width(width), by_lanes(lanes), by_cols(cols),
      by_slabs(slabs);
  // load (slab, k2, lane) in natural order; shared rows (slab, lane)
  for (int h = 0; h * kPer * (int)blockDim.x < share; ++h) {
    float2 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      v[k] = make_float2(0.f, 0.f);
      if (e < share) {
        const int j = by_width(e), r = e - j * width;
        const int k2 = by_lanes(r), l = r - k2 * lanes;
        if (l0 + l < L) {
          const int64_t src =
              ((plane + rank * slabs + j) * n2 + k2) * L + l0 + l;
          v[k] = make_float2(load_f(xr, src), load_f(xi, src));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      if (e < share) {
        const int j = by_width(e), r = e - j * width;
        const int k2 = by_lanes(r), l = r - k2 * lanes;
        buf[pad((j * lanes + l) * n2 + k2)] = v[k];
      }
    }
  }
  __syncthreads();
  stages(buf, tw2, plan2, slabs * lanes, inv);  // along n2
  // gather the n1-columns [rank*cols, rank*cols + cols): element e is
  // (k1, q) = (e / cols, e % cols), column c = rank*cols + q = k2*lanes + l,
  // held by block k1 / slabs in its row (k1 % slabs, l); it goes to n1-row q
  gather(
      cluster, buf, spare, share,
      [&](int e) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        const int c = rank * cols + q;
        const int k2 = by_lanes(c), l = c - k2 * lanes;
        const int owner = by_slabs(k1), j = k1 - owner * slabs;
        return cluster.map_shared_rank(buf, owner)[pad(
            (j * lanes + l) * n2 + k2)];
      },
      [=](int e) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        return q * n1 + k1;
      });
  stages(buf, tw1, plan1, cols, inv);  // along n1
  for (int h = 0; h * kPer * (int)blockDim.x < share; ++h) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = elem(h, k);
      if (e < share) {
        const int k1 = by_cols(e), q = e - k1 * cols;
        const int c = rank * cols + q;
        const int k2 = by_lanes(c), l = c - k2 * lanes;
        if (l0 + l < L) {
          const float2 w = buf[pad(q * n1 + k1)];
          const int64_t dst = ((plane + k1) * n2 + k2) * L + l0 + l;
          store_f(yr, dst, w.x * scale);
          store_f(yi, dst, w.y * scale);
        }
      }
    }
  }
}

// The launch configuration of `kernel` for `blocks` blocks in clusters of
// csize, with the kernel's attributes set (dynamic shared memory above
// 48 KB; a cluster of 16, above the portable 8).
template <typename Kernel>
cudaError_t configure(Kernel kernel, const Shape& s, long long blocks,
                      int csize, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = allow_smem(kernel, s.smem);
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
  cfg->blockDim = dim3((unsigned)s.threads);
  cfg->dynamicSmemBytes = s.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of `kernel` the device can hold at once (0: none).
template <typename Kernel>
int active_clusters(Kernel kernel, const Shape& s, int csize, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure(kernel, s, csize, csize, 0, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

template <typename T, int kThreads, int kMinBlocks, bool kFused>
int launch_cube(const T* xr, const T* xi, T* yr, T* yi, const void* tw1,
                const void* tw2, const void* tw3, long long pre,
                const Radices& p1, const Radices& p2, const Radices& p3,
                int csize, const Shape& s, int inverse, float scale,
                cudaStream_t stream) {
  auto* kernel = cube_fft_kernel<T, kThreads, kMinBlocks, kFused>;
  const long long blocks = pre * csize;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err =
      configure(kernel, s, blocks, csize, stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchKernelEx(&cfg, kernel, xr, xi, yr, yi,
                     static_cast<const float2*>(tw1),
                     static_cast<const float2*>(tw2),
                     static_cast<const float2*>(tw3), p1, p2, p3, csize,
                     inverse, scale);
  return (int)cudaGetLastError();
}

// K5 (kFused off: xr, xi, yr, yi are the four planes) or K16 (on: xr and
// yr are the fused input and output, xi and yi unused), for the checked
// cube geometry s.
template <typename T, bool kFused>
int launch_cube_typed(const void* xr, const void* xi, void* yr, void* yi,
                      const void* tw1, const void* tw2, const void* tw3,
                      long long pre, const Radices& p1, const Radices& p2,
                      const Radices& p3, int csize, const Shape& s,
                      int inverse, float scale, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xr);
  T* y = static_cast<T*>(yr);
  const T* x_im = kFused ? x + p3.n : static_cast<const T*>(xi);
  T* y_im = kFused ? y + p3.n : static_cast<T*>(yi);
  if (s.threads <= kPackedShare / kPer)
    return launch_cube<T, 512, 2, kFused>(x, x_im, y, y_im, tw1, tw2, tw3,
                                          pre, p1, p2, p3, csize, s, inverse,
                                          scale, stream);
  return launch_cube<T, 1024, 1, kFused>(x, x_im, y, y_im, tw1, tw2, tw3, pre,
                                         p1, p2, p3, csize, s, inverse, scale,
                                         stream);
}

template <typename T, int kThreads, int kMinBlocks>
int launch_mid(const void* xr, const void* xi, void* yr, void* yi,
               const void* tw1, const void* tw2, long long pre,
               const Radices& p1, const Radices& p2, long long L, int lanes,
               int csize, const Shape& s, int inverse, float scale,
               cudaStream_t stream) {
  auto* kernel = mid_pair_fft_kernel<T, kThreads, kMinBlocks>;
  const long long tiles = pre * ((L + lanes - 1) / lanes);
  if (tiles > INT_MAX / csize) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err =
      configure(kernel, s, tiles * csize, csize, stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xr),
                     static_cast<const T*>(xi), static_cast<T*>(yr),
                     static_cast<T*>(yi), static_cast<const float2*>(tw1),
                     static_cast<const float2*>(tw2), p1, p2, (int64_t)L,
                     lanes, csize, inverse, scale);
  return (int)cudaGetLastError();
}

// The (n1 / csize) * inner elements a block holds, or 0 when csize is not
// a cluster size, does not divide n1 or inner, or the share is over 16384.
inline int share_of(int n1, long long inner, int csize) {
  if (!cluster_ok(csize) || n1 % csize != 0 || inner % csize != 0)
    return 0;
  const long long share = (long long)(n1 / csize) * inner;
  return share <= kMaxN ? (int)share : 0;
}

// The block geometry of a cube, or threads = 0 outside the envelope.
inline Shape cube_shape(int n1, int n2, int n3, int csize) {
  Shape s = {0, 0, 0};
  const int share = share_of(n1, (long long)n2 * n3, csize);
  if (n2 < 1 || n3 < 1 || share == 0) return s;
  const Shape g = block_shape(share);
  const int slabs = n1 / csize;
  if (stages_fit(n2, slabs * n3, g.threads) &&
      stages_fit(n3, slabs * n2, g.threads) &&
      stages_fit(n1, share / n1, g.threads))
    s = g;
  return s;
}

// The block geometry of a mid-pair tile, or threads = 0 outside the
// envelope.
inline Shape mid_shape(int n1, int n2, int lanes, int csize) {
  Shape s = {0, 0, 0};
  const int share = share_of(n1, (long long)n2 * lanes, csize);
  if (n2 < 1 || lanes < 1 || share == 0) return s;
  const Shape g = block_shape(share);
  if (stages_fit(n2, (n1 / csize) * lanes, g.threads) &&
      stages_fit(n1, share / n1, g.threads))
    s = g;
  return s;
}

template <bool kFused>
int cube_entry(const void* xr, const void* xi, void* yr, void* yi,
               const void* tw1, const void* tw2, const void* tw3,
               long long pre, int n1, int n2, int n3, int csize,
               const int* rad1, int nstages1, const int* rad2, int nstages2,
               const int* rad3, int nstages3, int inverse, float scale,
               int bf16, void* stream) {
  Radices p1, p2, p3;
  if (pre < 0 || n1 < 2 || n2 < 2 || n3 < 2 ||
      !make_radices(n1, rad1, nstages1, &p1) ||
      !make_radices(n2, rad2, nstages2, &p2) ||
      !make_radices(n3, rad3, nstages3, &p3))
    return (int)cudaErrorInvalidValue;
  const Shape s = cube_shape(n1, n2, n3, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_cube_typed<__nv_bfloat16, kFused>(
        xr, xi, yr, yi, tw1, tw2, tw3, pre, p1, p2, p3, csize, s, inverse,
        scale, st);
  return launch_cube_typed<float, kFused>(xr, xi, yr, yi, tw1, tw2, tw3, pre,
                                          p1, p2, p3, csize, s, inverse,
                                          scale, st);
}

template <bool kFused>
int cube_clusters(int n1, int n2, int n3, int csize, int bf16, int* out) {
  const Shape s = cube_shape(n1, n2, n3, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  if (s.threads <= kPackedShare / kPer)
    return bf16 ? active_clusters(
                      cube_fft_kernel<__nv_bfloat16, 512, 2, kFused>, s,
                      csize, out)
                : active_clusters(cube_fft_kernel<float, 512, 2, kFused>, s,
                                  csize, out);
  return bf16 ? active_clusters(
                    cube_fft_kernel<__nv_bfloat16, 1024, 1, kFused>, s,
                    csize, out)
              : active_clusters(cube_fft_kernel<float, 1024, 1, kFused>, s,
                                csize, out);
}

}  // namespace

// Transforms the three trailing axes of the (pre, n1, n2, n3) planes xr/xi
// into the planes yr/yi (f32, or bf16 when bf16 != 0) on `stream`, a
// stream of the current device, one cluster of csize blocks a cube. tw1,
// tw2, tw3 hold exp(-+2 pi i k / n) for n1, n2, n3 as complex f32 for the
// direction; rad1..3 multiply to n1..n3, each radix 2, 4, 8 or an odd value
// up to 127; n1, n2, n3 >= 2; csize in {1, 2, 4, 8, 16} divides n1 and
// n2 * n3, (n1 / csize) * n2 * n3 <= 16384, and each axis's rows split
// into chunks of whole rows at 16-element boundaries (chunk_rows). Returns
// 0 or the CUDA error code of the launch.
extern "C" int tpufft_cube_fft(const void* xr, const void* xi, void* yr,
                               void* yi, const void* tw1, const void* tw2,
                               const void* tw3, long long pre, int n1, int n2,
                               int n3, int csize, const int* rad1,
                               int nstages1, const int* rad2, int nstages2,
                               const int* rad3, int nstages3, int inverse,
                               float scale, int bf16, void* stream) {
  return cube_entry<false>(xr, xi, yr, yi, tw1, tw2, tw3, pre, n1, n2, n3,
                           csize, rad1, nstages1, rad2, nstages2, rad3,
                           nstages3, inverse, scale, bf16, stream);
}

// K16: tpufft_cube_fft on fused storage. Transforms the three trailing
// logical axes of the (pre, n1, n2, 2*n3) array st, each n3-row stored as
// [re | im], into `out` of the same shape; every other argument and
// condition as for tpufft_cube_fft. Returns 0 or the CUDA error code.
extern "C" int tpufft_cube_fft_fused(const void* st, void* out,
                                     const void* tw1, const void* tw2,
                                     const void* tw3, long long pre, int n1,
                                     int n2, int n3, int csize,
                                     const int* rad1, int nstages1,
                                     const int* rad2, int nstages2,
                                     const int* rad3, int nstages3,
                                     int inverse, float scale, int bf16,
                                     void* stream) {
  return cube_entry<true>(st, nullptr, out, nullptr, tw1, tw2, tw3, pre, n1,
                          n2, n3, csize, rad1, nstages1, rad2, nstages2, rad3,
                          nstages3, inverse, scale, bf16, stream);
}

// Into *out, how many clusters of tpufft_cube_fft at (n1, n2, n3, csize)
// the current device holds at once (cudaOccupancyMaxActiveClusters).
// Returns 0 or the CUDA error code.
extern "C" int tpufft_cube_active_clusters(int n1, int n2, int n3, int csize,
                                           int bf16, int* out) {
  return cube_clusters<false>(n1, n2, n3, csize, bf16, out);
}

// The same for tpufft_cube_fft_fused.
extern "C" int tpufft_cube_fused_active_clusters(int n1, int n2, int n3,
                                                 int csize, int bf16,
                                                 int* out) {
  return cube_clusters<true>(n1, n2, n3, csize, bf16, out);
}

// Transforms axes 1 and 2 of the (pre, n1, n2, L) planes xr/xi into the
// planes yr/yi (f32, or bf16 when bf16 != 0) on `stream`, one cluster of
// csize blocks a tile of `lanes` contiguous elements of L (the ragged end
// masked). tw1, tw2 hold exp(-+2 pi i k / n) for n1 and n2; rad1, rad2 as
// for tpufft_cube_fft; n1, n2 >= 2, L >= 1, 1 <= lanes <= 64; csize in
// {1, 2, 4, 8, 16} divides n1 and n2 * lanes,
// (n1 / csize) * n2 * lanes <= 16384, and each axis's rows split into
// chunks as for the cube. Returns 0 or the CUDA error code.
extern "C" int tpufft_mid_pair_fft(const void* xr, const void* xi, void* yr,
                                   void* yi, const void* tw1,
                                   const void* tw2, long long pre, int n1,
                                   int n2, long long L, int lanes, int csize,
                                   const int* rad1, int nstages1,
                                   const int* rad2, int nstages2, int inverse,
                                   float scale, int bf16, void* stream) {
  Radices p1, p2;
  if (pre < 0 || L < 1 || n1 < 2 || n2 < 2 || lanes < 1 || lanes > 64 ||
      !make_radices(n1, rad1, nstages1, &p1) ||
      !make_radices(n2, rad2, nstages2, &p2))
    return (int)cudaErrorInvalidValue;
  const Shape s = mid_shape(n1, n2, lanes, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.threads <= kPackedShare / kPer) {
    if (bf16)
      return launch_mid<__nv_bfloat16, 512, 2>(xr, xi, yr, yi, tw1, tw2, pre,
                                               p1, p2, L, lanes, csize, s,
                                               inverse, scale, st);
    return launch_mid<float, 512, 2>(xr, xi, yr, yi, tw1, tw2, pre, p1, p2, L,
                                     lanes, csize, s, inverse, scale, st);
  }
  if (bf16)
    return launch_mid<__nv_bfloat16, 1024, 1>(xr, xi, yr, yi, tw1, tw2, pre,
                                              p1, p2, L, lanes, csize, s,
                                              inverse, scale, st);
  return launch_mid<float, 1024, 1>(xr, xi, yr, yi, tw1, tw2, pre, p1, p2, L,
                                    lanes, csize, s, inverse, scale, st);
}

// Into *out, how many clusters of tpufft_mid_pair_fft at (n1, n2, lanes,
// csize) the current device holds at once. Returns 0 or the CUDA error code.
extern "C" int tpufft_mid_pair_active_clusters(int n1, int n2, int lanes,
                                               int csize, int bf16,
                                               int* out) {
  const Shape s = mid_shape(n1, n2, lanes, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  if (s.threads <= kPackedShare / kPer)
    return bf16 ? active_clusters(
                      mid_pair_fft_kernel<__nv_bfloat16, 512, 2>, s, csize,
                      out)
                : active_clusters(mid_pair_fft_kernel<float, 512, 2>, s,
                                  csize, out);
  return bf16 ? active_clusters(mid_pair_fft_kernel<__nv_bfloat16, 1024, 1>,
                                s, csize, out)
              : active_clusters(mid_pair_fft_kernel<float, 1024, 1>, s, csize,
                                out);
}
