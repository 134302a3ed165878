// The cluster line form of the strided-axis C2C FFT (K2, K3, K18, K19)
// above the four-step's reach: f32 n from 2160 to 16384 and bf16 n from
// 1080 (the lists below), where a unit's tile of C n complex f32 values no
// longer fits one block (256 KB at n = 2048, 2 MB at 16384).
// strided_fft.cu picks the form; strided_long_{a,b}_{f32,bf16}.cu
// instantiate this header's kernel, one nvcc each.
//
// Replaces the same Pallas TPU kernels as the other two forms
// (tpufft/kernels/mxu_fft.py: _build_inner, _build_inner_nd with with_tw,
// _build_inner_fused, _build_inner_fused_m1), with the same contract
// (strided_line.cuh's header): (pre, n, post) planes or fused storage
// (kFused), f32 or bf16 storage, f32 arithmetic, tw_nm (kTw) and one
// scale at the store, every twiddle from the host-f64 n-table.
//
// The design: a three-factor four-step n = N1 N2 N3 (M = N2 N3, each
// factor whole in one lane, lane_dft.cuh) whose tile is spread over a
// thread-block cluster of Q blocks (distributed shared memory). A unit is
// C = 16 consecutive columns of one pre-slice, so each row read or written
// is a 64-byte run a plane in f32 (a 32-byte sector in bf16). On the H100
// units of 8 f32 columns (32-byte rows) ran 1.09-1.50x slower at
// 3840-16384 (tools/strided_long_ab.py, PERF.md). Block b of a cluster
// owns the rows k1 in [b K, b K + K), K = N1 / Q, of the unit's tile for
// every column and every u < M. Every element crosses device memory once
// each way.
// - Pass 1 (device memory -> the owners' tiles): the cluster's M C lines
//   (c, u), u = N3 j2 + j3, are split into Q runs of M C / Q, one a block;
//   lane (c, u) loads x[M j1 + u, c] for every j1 straight from device
//   memory (lanes on consecutive columns, then u), runs the N1-long line in
//   registers, multiplies output k1 by w^(k1 u) = A[k1][j2] B[k1][j3] (small
//   tables staged once a block, as the minor axis' LongStep) and writes it
//   into the tile of block k1 / K through map_shared_rank.
// - The cluster barrier (arrive with release, wait with acquire).
// - Pass 2 (own tile, in place): the K N3 C lines (k1, j3, c) over j2, times
//   w^(N1 k2 j3); a block barrier.
// - Pass 3 (own tile -> device memory): the K N2 C lines (k1, k2, c) over
//   j3, stored to X[k1 + N1 (k2 + N2 k3), c] from registers with tw_nm and
//   the scale, lanes on consecutive columns.
// - Before the next unit's pass 1 writes into a tile, its owner must have
//   read it: each block arrives on the cluster barrier after pass 3 and
//   waits on it after the next unit's loads, so those loads and nothing
//   else overlap the wait. Two tiles a block in turn (one barrier a unit)
//   ran 1.09-1.25x slower on the H100: twice the shared memory leaves one
//   block an SM (tools/strided_long_ab.py, PERF.md).
// The tile holds (k1 - b K, c2, j3, c) (c2 = j2, then k2) at ((kk N2 + c2)
// N3 + j3) C + c: a half warp's 16 lanes are the 16 columns of one line,
// so no access of any pass, the remote writes of pass 1 included, meets a
// bank conflict (a CPU test, tests/test_torch_strided_geometry.py, walks
// every geometry). With kSwap (pass 1 of the two-pass split, with kTw) the
// outputs go to the (pre, M, n, L) order of strided_line.cuh's out_at,
// where a block's own rows k1 make runs of K values. So where pass 3 holds
// all its lines at once (S3 = H3: 1920, 2048, 3840, 4096, 7680, 8192, 15360
// and 16384) and L divides C, the kernel restages the unit over the
// cluster (kRestage): a cluster barrier once every block has read its
// tile, pass 3's twiddled, scaled outputs written into the tile of the
// block that owns their rows k in [b R, b R + R), R = n / Q, as (c, k - b
// R) rows (restage_pos), a cluster barrier, and each block's C R outputs
// stored by consecutive threads in runs of R L values. Elsewhere pass 3
// stores straight. Q is the smallest of 1, 2, 4, 8, 16 that leaves two
// blocks of 256 threads an SM (at most 128 registers); where none does
// (15360 and 16384) Q = 16 and one block of 512. The grid holds at most
// the clusters the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), and each cluster loops over units, so
// that the tables are staged once a block.

#pragma once

#include <cooperative_groups.h>

#include "strided_line.cuh"

namespace tpufft_strided {

namespace cg = cooperative_groups;
using tpufft_minor::long_hold;
using tpufft_minor::long_line;

constexpr int kLongCols = 16;  // C, columns a unit

// A block's shared memory in float2: the line tables W_N1, W_N2, W_N3 at
// pad(m), then A (N1 N2), B (N1 N3) and C (N2 N3), then the tile of K rows
// of M C values.
__host__ __device__ constexpr int cluster_table(int n1, int n2, int n3) {
  return (n1 + n1 / 16 + 1) + (n2 + n2 / 16 + 1) + (n3 + n3 / 16 + 1) +
         n1 * n2 + n1 * n3 + n2 * n3;
}
__host__ __device__ constexpr size_t cluster_smem(int n1, int n2, int n3,
                                                  int q) {
  const int tile = (n1 / q) * n2 * n3 * kLongCols;
  return (size_t)(cluster_table(n1, n2, n3) + tile) * sizeof(float2);
}

// The geometry of the cluster form at n = N1 N2 N3 over a cluster of kQ
// blocks of kThreads threads. Line i of a block's pass goes to lane i mod
// kThreads in round i / kThreads; a pass takes its rounds H at a time
// (their values held at once).
template <int kN1, int kN2, int kN3, int kQ, int kThreads>
struct ClusterStep {
  static constexpr int N1 = kN1, N2 = kN2, N3 = kN3, n = kN1 * kN2 * kN3;
  static constexpr int M = N2 * N3, Q = kQ, K = N1 / kQ, C = kLongCols;
  static constexpr int cols_log2 = 4;
  static constexpr int threads = kThreads;
  static constexpr int lines1 = M * C / Q;   // a block's, of the cluster's
  static constexpr int lines2 = K * N3 * C;  // the block's own rows
  static constexpr int lines3 = K * N2 * C;
  static constexpr int S1 = (lines1 + kThreads - 1) / kThreads;  // rounds
  static constexpr int S2 = (lines2 + kThreads - 1) / kThreads;
  static constexpr int S3 = (lines3 + kThreads - 1) / kThreads;
  static constexpr int H1 = long_hold(N1, S1), H2 = long_hold(N2, S2),
                       H3 = long_hold(N3, S3);
  static constexpr bool emit1 = max_prime(N1) >= 7;
  static constexpr bool emit2 = max_prime(N2) >= 7;
  static constexpr bool emit3 = max_prime(N3) >= 7;
  static constexpr int w1 = 0, w2 = w1 + N1 + N1 / 16 + 1,
                       w3 = w2 + N2 + N2 / 16 + 1,
                       ta = w3 + N3 + N3 / 16 + 1, tb = ta + N1 * N2,
                       tc = tb + N1 * N3, table = tc + N2 * N3;
  static constexpr int tile = K * M * C;
  static constexpr size_t smem = cluster_smem(N1, N2, N3, Q);
  // at most 128 registers: two blocks of 256 threads an SM, one of 512
  static constexpr int min_blocks = 512 / kThreads < 1 ? 1 : 512 / kThreads;
  static_assert(smem == (table + tile) * sizeof(float2), "shared memory");
  static_assert(N1 <= 32 && N2 <= 32 && N3 <= 32 && kThreads % 32 == 0,
                "lines whole in a lane");
  static_assert(N1 % kQ == 0 && (M * C) % kQ == 0, "ownership");

  static __device__ __forceinline__ int pos(int kk, int c2, int j3, int c) {
    return ((kk * N2 + c2) * N3 + j3) * C + c;
  }
};

__device__ __forceinline__ void long_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void long_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The cluster form (ClusterStep S; the header's notes). Cluster g of the
// grid takes units g, g + clusters, ...; every block of a cluster runs the
// same units, so that every thread meets every cluster barrier. Columns
// past post compute on zeros and store nothing; a warp whose lines of a
// round all lie past its pass's lines skips the round's line DFTs.
template <typename T, typename S, bool kFused, bool kTw, bool kSwap>
__global__ void __launch_bounds__(S::threads, S::min_blocks)
strided_cluster_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                       T* __restrict__ yr, T* __restrict__ yi,
                       const float2* __restrict__ tw,
                       const float2* __restrict__ tw_nm, int64_t pre,
                       int post, int tw_m, int tw_l, int inverse,
                       float scale) {
  constexpr int n = S::n, N1 = S::N1, N2 = S::N2, N3 = S::N3, M = S::M;
  constexpr int K = S::K, C = S::C, TH = S::threads, CL = S::cols_log2;
  extern __shared__ float2 tpufft_strided_long_smem[];
  float2* table = tpufft_strided_long_smem;
  float2* const tile = table + S::table;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int t = threadIdx.x, warp0 = t & ~31;
  const bool inv = inverse != 0;
  for (int m = t; m < N1; m += TH)
    table[S::w1 + pad(m)] = __ldg(&tw[m * (n / N1)]);
  for (int m = t; m < N2; m += TH)
    table[S::w2 + pad(m)] = __ldg(&tw[m * (n / N2)]);
  for (int m = t; m < N3; m += TH)
    table[S::w3 + pad(m)] = __ldg(&tw[m * (n / N3)]);
  for (int i = t; i < N1 * N2; i += TH)
    table[S::ta + i] = __ldg(&tw[(i / N2) * (i % N2) * N3]);
  for (int i = t; i < N1 * N3; i += TH)
    table[S::tb + i] = __ldg(&tw[(i / N3) * (i % N3)]);
  for (int i = t; i < N2 * N3; i += TH)
    table[S::tc + i] = __ldg(&tw[N1 * (i / N3) * (i % N3)]);
  __syncthreads();
  long_arrive();  // this block has started
  const int64_t stride = kFused ? 2 * (int64_t)post : post;
  const int64_t groups = (post + C - 1) >> CL;
  const int64_t units = pre * groups;
  const int64_t clusters = gridDim.x / S::Q;
  for (int64_t u = blockIdx.x / S::Q; u < units; u += clusters) {
    int64_t p;
    int c0;
    unit_at<kSwap>(u, pre, groups, CL, p, c0);
    const int64_t slab = p * n;
#pragma unroll
    for (int r = 0; r < S::S1; r += S::H1) {  // pass 1: lines (c, u)
      float2 v[S::H1][N1];
#pragma unroll
      for (int h = 0; h < S::H1; ++h) {
        const int i = t + TH * (r + h);
        const int l = b * S::lines1 + i;
        const int col = c0 + (l & (C - 1));
        const bool live = r + h < S::S1 && i < S::lines1 && col < post;
        const int64_t g0 = (slab + (l >> CL)) * stride +
                           col_offset<kFused>(col, tw_l);
#pragma unroll
        for (int j = 0; j < N1; ++j) {
          const int64_t g = g0 + (int64_t)(M * j) * stride;
          v[h][j] = live ? make_float2(load_f(xr, g), load_f(xi, g))
                         : make_float2(0.f, 0.f);
        }
      }
      // every block has started (the first unit) or read its tile (the
      // previous unit's pass 3)
      if (r == 0) long_wait();
#pragma unroll
      for (int h = 0; h < S::H1; ++h) {
        const int i = t + TH * (r + h);
        if (r + h >= S::S1 || warp0 + TH * (r + h) >= S::lines1) continue;
        const int l = b * S::lines1 + i;
        const int c = l & (C - 1), uu = l >> CL;
        const int j2 = uu / N3, j3 = uu - j2 * N3;
        const bool live = i < S::lines1;
        long_line<N1, S::emit1>(v[h], table + S::w1, inv,
                                [&](int k1, float2 y) {
          if (live) {
            float2* dst = cluster.map_shared_rank(tile, k1 / K);
            dst[S::pos(k1 % K, j2, j3, c)] =
                k1 == 0 ? y
                        : cmul(y, cmul(table[S::ta + k1 * N2 + j2],
                                       table[S::tb + k1 * N3 + j3]));
          }
        });
      }
    }
    long_arrive();  // every block's tile is whole
    long_wait();
#pragma unroll
    for (int r = 0; r < S::S2; r += S::H2) {  // pass 2: lines (k1, j3, c)
      float2 v[S::H2][N2];
#pragma unroll
      for (int h = 0; h < S::H2; ++h) {
        const int w = t + TH * (r + h);
        const bool live = r + h < S::S2 && w < S::lines2;
        const int c = w & (C - 1), q = w >> CL;
        const int kk = q / N3, j3 = q - kk * N3;
#pragma unroll
        for (int j = 0; j < N2; ++j)
          v[h][j] = live ? tile[S::pos(kk, j, j3, c)] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < S::H2; ++h) {
        const int w = t + TH * (r + h);
        if (r + h >= S::S2 || warp0 + TH * (r + h) >= S::lines2) continue;
        const int c = w & (C - 1), q = w >> CL;
        const int kk = q / N3, j3 = q - kk * N3;
        const bool live = w < S::lines2;
        long_line<N2, S::emit2>(v[h], table + S::w2, inv,
                                [&](int k2, float2 y) {
          if (live)
            tile[S::pos(kk, k2, j3, c)] =
                k2 == 0 ? y : cmul(y, table[S::tc + k2 * N3 + j3]);
        });
      }
    }
    __syncthreads();
    constexpr int R = n / S::Q;  // the rows k a block stores, restaged
    constexpr bool kRestage =
        kSwap && S::S3 == S::H3 && R % 16 == 0;
    const bool restage = kRestage && (C % tw_l) == 0;
#pragma unroll
    for (int r = 0; r < S::S3; r += S::H3) {  // pass 3: lines (k1, k2, c)
      float2 v[S::H3][N3];
#pragma unroll
      for (int h = 0; h < S::H3; ++h) {
        const int w = t + TH * (r + h);
        const bool live = r + h < S::S3 && w < S::lines3;
        const int c = w & (C - 1), q = w >> CL;
        const int kk = q / N2, k2 = q - kk * N2;
#pragma unroll
        for (int j = 0; j < N3; ++j)
          v[h][j] = live ? tile[S::pos(kk, k2, j, c)] : make_float2(0.f, 0.f);
      }
      if constexpr (kRestage) {
        if (restage) {  // every block has read its tile (S3 = H3: one round)
          long_arrive();
          long_wait();
        }
      }
#pragma unroll
      for (int h = 0; h < S::H3; ++h) {
        const int w = t + TH * (r + h);
        if (r + h >= S::S3 || warp0 + TH * (r + h) >= S::lines3) continue;
        const int c = w & (C - 1), q = w >> CL;
        const int kk = q / N2, k2 = q - kk * N2;
        const int col = c0 + c;
        const bool live = w < S::lines3 && col < post;
        const int k0 = b * K + kk + N1 * k2;  // X[k0 + N1 N2 k3]
        const int64_t g0 =
            out_at<kFused, kSwap>(slab, k0, stride, col, tw_l, n);
        const int64_t ks = out_step<kSwap>(stride, tw_l);
        const int cq = kTw ? col / tw_l : 0;
        long_line<N3, S::emit3>(v[h], table + S::w3, inv,
                                [&](int k3, float2 y) {
          if (!live) return;
          const int k = k0 + N1 * N2 * k3;
          if constexpr (kRestage) {
            if (restage) {
              y = cmul(y, __ldg(&tw_nm[(int64_t)k * tw_m + cq]));
              cluster.map_shared_rank(tile, k / R)[restage_pos(
                  c, k % R, R)] = make_float2(y.x * scale, y.y * scale);
              return;
            }
          }
          store_out<kTw>(yr, yi, tw_nm, g0 + (int64_t)(N1 * N2 * k3) * ks,
                         k, tw_m, cq, y, scale);
        });
      }
    }
    if constexpr (kRestage) {
      if (restage) {  // every output is in its owner's tile: store them
        long_arrive();
        long_wait();
        // output e of the block is (column c0 + (e / (R L)) L + e mod L,
        // row b R + e / L mod R)
        const int ll = __ffs(tw_l) - 1;
        const int64_t base = slab * stride + (int64_t)c0 * n;
        for (int e = t; e < R * C; e += TH) {
          const int r2 = e >> ll, mm = r2 / R, kl = r2 - mm * R;
          const int cc = (mm << ll) + (e & (tw_l - 1));
          if (c0 + cc < post) {
            const float2 w = tile[restage_pos(cc, kl, R)];
            const int64_t g = base + (int64_t)mm * n * tw_l +
                              (int64_t)(b * R + kl) * tw_l + (e & (tw_l - 1));
            store_f(yr, g, w.x);
            store_f(yi, g, w.y);
          }
        }
      }
    }
    long_arrive();  // this block's tile is read
  }
  long_wait();
}

// ---------------------------------------------------------------------------
// Host: the lists, geometry and launch
// ---------------------------------------------------------------------------

// The lengths of the cluster form, in two lists (each list and storage
// instantiated by a source of its own, so that nvcc builds them in
// parallel): X(n, N1, N2, N3, Q, threads), ClusterStep's parameters. f32
// takes the lengths above 2048 (the four-step line form takes those up to
// 2048), bf16 all of them. The wrapper's model
// (tests/test_torch_strided_geometry.py, CLUSTER) lists the same
// geometries, and a CPU test holds the two equal.
#define TPUFFT_STRIDED_LONG_A(X) \
  X(1080, 30, 2, 18, 2, 256)     \
  X(1280, 16, 4, 20, 2, 256)     \
  X(1536, 16, 3, 32, 2, 256)     \
  X(1920, 16, 4, 30, 4, 256)     \
  X(2048, 16, 4, 32, 4, 256)     \
  X(2160, 16, 5, 27, 4, 256)     \
  X(2560, 16, 5, 32, 4, 256)     \
  X(3072, 16, 6, 32, 4, 256)     \
  X(3840, 16, 8, 30, 8, 256)     \
  X(4096, 16, 8, 32, 8, 256)
#define TPUFFT_STRIDED_LONG_B(X) \
  X(4320, 16, 9, 30, 8, 256)     \
  X(5120, 16, 10, 32, 8, 256)    \
  X(6144, 16, 12, 32, 8, 256)    \
  X(7680, 16, 15, 32, 16, 256)   \
  X(8192, 16, 16, 32, 16, 256)   \
  X(8320, 16, 20, 26, 16, 256)   \
  X(10240, 16, 20, 32, 16, 256)  \
  X(12288, 16, 24, 32, 16, 256)  \
  X(15360, 16, 30, 32, 16, 512)  \
  X(16384, 16, 32, 32, 16, 512)

// The longest length f32 leaves to the four-step line form.
constexpr int kLongF32Above = 2048;

struct ClusterGeometry {
  int n1, n2, n3, q;  // the split and the cluster's blocks
  int threads;        // a block
  int family;         // the list that holds it: 0 (A) or 1 (B)
  size_t smem;        // bytes a block
};

// The cluster form's geometry for n and post in f32 or bf16 storage; false
// (the stage form) where n is on no list, f32 n is at most 2048, or post
// holds fewer than 8 f32 (16 bf16) columns (a unit's columns past post
// compute on zeros and store nothing).
inline bool cluster_geometry(int n, long long post, bool bf16,
                             ClusterGeometry* g) {
  bool found = false;
#define TPUFFT_LONG_FIND(list, n_, n1_, n2_, n3_, q_, th_)                 \
  if (n == n_) {                                                           \
    *g = ClusterGeometry{n1_, n2_, n3_, q_, th_, list,                     \
                         cluster_smem(n1_, n2_, n3_, q_)};                 \
    found = true;                                                          \
  }
#define TPUFFT_LONG_FIND_A(...) TPUFFT_LONG_FIND(0, __VA_ARGS__)
#define TPUFFT_LONG_FIND_B(...) TPUFFT_LONG_FIND(1, __VA_ARGS__)
  TPUFFT_STRIDED_LONG_A(TPUFFT_LONG_FIND_A)
  TPUFFT_STRIDED_LONG_B(TPUFFT_LONG_FIND_B)
#undef TPUFFT_LONG_FIND_A
#undef TPUFFT_LONG_FIND_B
#undef TPUFFT_LONG_FIND
  return found && (bf16 || n > kLongF32Above) && post >= (bf16 ? 16 : 8) &&
         g->smem <= kSmemMax;
}

// The kernel of geometry S on at most the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters, about 1 us of host time a launch on the
// H100; an error where it holds none), each looping over units; with
// tw_nm (never on fused storage) the kTw kernel.
template <typename T, typename S, bool kFused, bool kTw, bool kSwap>
int launch_cluster_as(const LineArgs& a, const ClusterGeometry& g) {
  auto* kernel = strided_cluster_kernel<T, S, kFused, kTw, kSwap>;
  if (g.n1 != S::N1 || g.n2 != S::N2 || g.n3 != S::N3 || g.q != S::Q ||
      g.threads != S::threads || g.smem != S::smem)
    return (int)cudaErrorInvalidValue;
  const long long units = a.pre * ((a.post + S::C - 1) >> S::cols_log2);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, g.threads, g.smem, g.q, g.q,
                                   a.stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const long long clusters = units < resident ? units : resident;
  err = cluster_config(kernel, g.threads, g.smem, clusters * g.q, g.q,
                       a.stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.xr),
                     static_cast<const T*>(a.xi), static_cast<T*>(a.yr),
                     static_cast<T*>(a.yi), static_cast<const float2*>(a.tw),
                     static_cast<const float2*>(a.tw_nm), (int64_t)a.pre,
                     (int)a.post, a.tw_m, (int)a.tw_l, a.inverse, a.scale);
  return (int)cudaGetLastError();
}

// The launchers of each list (strided_long_{a,b}_{f32,bf16}.cu, each
// source instantiating its list in its storage): the length's kernel in
// storage T, or cudaErrorInvalidValue for a length the list does not hold.
template <typename T, bool kFused>
int launch_cluster_a(const LineArgs& a, const ClusterGeometry& g);
template <typename T, bool kFused>
int launch_cluster_b(const LineArgs& a, const ClusterGeometry& g);

template <typename T, bool kFused>
int launch_cluster(const LineArgs& a, const ClusterGeometry& g) {
  return g.family == 0 ? launch_cluster_a<T, kFused>(a, g)
                       : launch_cluster_b<T, kFused>(a, g);
}

// The body of each source: its list's switch over n (the kTw kernel where
// tw_nm is set, with the swapped store where swap is set too, never on
// fused storage; f32 only above kLongF32Above) and the launcher's
// instantiations in its storage T (plain and fused).
#define TPUFFT_LONG_CASE(n_, n1, n2, n3, q, th)                            \
  case n_:                                                                 \
    if constexpr (kBf16 || n_ > kLongF32Above) {                           \
      using S = ClusterStep<n1, n2, n3, q, th>;                            \
      if constexpr (!kFused)                                               \
        if (a.tw_nm != nullptr)                                            \
          return a.swap                                                    \
                     ? launch_cluster_as<T, S, kFused, true, true>(a, g)   \
                     : launch_cluster_as<T, S, kFused, true, false>(a, g); \
      return launch_cluster_as<T, S, kFused, false, false>(a, g);          \
    }                                                                      \
    break;
#define TPUFFT_LONG_FAMILY(NAME, LIST, STORAGE)                            \
  template <typename T, bool kFused>                                       \
  int NAME(const LineArgs& a, const ClusterGeometry& g) {                  \
    constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;          \
    switch (g.n1 * g.n2 * g.n3) { LIST(TPUFFT_LONG_CASE) }                \
    return (int)cudaErrorInvalidValue;                                     \
  }                                                                        \
  template int NAME<STORAGE, false>(const LineArgs&,                       \
                                    const ClusterGeometry&);               \
  template int NAME<STORAGE, true>(const LineArgs&, const ClusterGeometry&);

}  // namespace tpufft_strided
