// Multi-axis C2C FFTs whose tile outgrows one block's shared memory, run on
// a thread-block cluster that holds the tile in distributed shared memory:
//
// - K5, tpufft_cube_fft: the three trailing axes of (pre, n1, n2, n3)
//   planes in one pass. Replaces tpufft/kernels/mxu_fft.py:1941,
//   _build_3d.
// - K16, tpufft_cube_fft_fused: K5 on fused storage (pre, n1, n2, 2*n3),
//   each n3-row [re | im] (fft_stages.cuh). Replaces
//   tpufft/kernels/mxu_fft.py:2046, _build_3d_fused; only the load and the
//   store differ from K5, through the kernels' kFused flag.
// - K6, tpufft_mid_pair_fft: axes 1 and 2 of (pre, n1, n2, L) planes in
//   one pass, L the contiguous batch (fftn(axes=(1, 2)) of a channels-last
//   (B, H, W, C) array). Replaces tpufft/kernels/mxu_fft.py:_build_mid_pair.
//
// Contract as there: f32 or bf16 storage, f32 arithmetic, a forward/inverse
// flag, and one real scale applied once at the store. Plain C entry points
// for ctypes (tpufft_torch/kernels/cube_fft.py, mid_pair_fft.py and
// fused_fft.py bind and check them).
//
// What bounds them on an H100: device-memory bandwidth by the bytes (~3
// flop/byte an axis): run axis by axis, a 3-D transform reads and writes
// the planes three times and a middle pair twice; these kernels do it
// once. A 64^3 c64 cube is 2 MiB and one block holds at most 227 KB, so
// the tile is split along n1 over a cluster of C blocks (C in 1, 2, 4, 8,
// 16; C = 16 is a non-portable cluster size, allowed per kernel), each
// holding at most 16384 elements. Block b holds slabs [b n1/C, (b+1) n1/C)
// of n1; after a cluster barrier it owns 1/C of the n1-columns (a
// contiguous run of flat (k2, k3) positions) and reads them, n1 values
// each, from the cluster's shared memory (map_shared_rank).
//
// The cube kernel has two forms (kernels/cube_fft.py:form mirrors the
// choice; the entry point makes it):
//
// The line form (cube_line_kernel), for cubes whose three axes are powers
// of two from 2 to 64 (64^3, 32^3, the lane-fused plans' cubes). A line of
// length n is owned by G = n/V lanes of one warp (line_fft.cuh), V =
// min(n, 8) values each: lane l holds x[l + G j], runs its radix-V
// butterfly in registers, multiplies by w^(l a) from the f64-built
// table, swaps values with the other lanes of its line by __shfl_xor_sync
// (log2 G exchanges that swap a lane bit with a register bit), and runs
// radix-G butterflies in registers. No barrier and no shared memory inside a line. A thread holds
// 16 values, K = 16/V lines, in 512 threads or fewer; a 16384-element
// block takes two rounds of them, with nothing parked between rounds.
//   1. the n3 rows: read from device memory straight into registers
//      (8 consecutive elements of 4 rows a warp instruction at n3 = 64),
//      transformed and written to the tile in natural order;
//   2. __syncthreads; the n2 columns of each slab, read from the tile into
//      registers, transformed and written back in place;
//   3. cluster.sync; each lane group reads its n1-columns' values from
//      the owning blocks (two adjacent columns a lane, one 16-byte load a
//      value pair), transforms them and stores them to device memory from
//      registers: at n1 = 64 a warp store writes 8 consecutive columns of
//      each of 8 rows, one 32-byte sector a row in f32 (16 bytes in bf16).
//      Nothing is written to the local tile after the exchange. Each thread
//      arrives on the cluster barrier after its last remote read
//      (barrier.cluster.arrive, a release) and waits on it before exit, so
//      the last stores overlap the wait while every block's memory stays
//      in place until the cluster has read it.
// The tile's n3-rows lie at pitch n3 + 4 (n3 >= 32; + 2 below) and its
// slabs at n2 (n3 + pad) + 8 float2: at 64^3 every shared access of the
// three phases is free of bank conflicts (a half warp on 4 rows x 4
// columns, a quarter warp of 16-byte reads on 2 slabs x 8 columns);
// 32-long rows take 2-way conflicts in the n3 writes and n2 reads.
// A 64^3 block takes 136 KB (one block an SM, 7 clusters of 16 at once on
// the H100), with no spare region.
//
// K6 has a line form too (mid_pair_line_kernel; kernels/mid_pair_fft.py:
// form mirrors line_mid), for power-of-two n1 and n2 from 2 to 128 (a
// 128-line is 8 lanes of 16 values): a tile of 8 contiguous elements of
// L (an f32 row one 32-byte sector), the cluster split along n1 as above.
//   1. the block's rows of 8 L-elements, read 4 rows a warp instruction
//      (16 rows of 16-byte loads where L % 4 == 0) and written to the
//      tile (MidTile: two rows a bank row, the groups of 4 swizzled by
//      k2, slabs 8 float2 apart), the ragged end of L as zeros;
//   2. __syncthreads; the n2 lines (slab, lane of L) from the tile into
//      registers, transformed, written back in place;
//   3. cluster.sync; each lane group reads its n1-columns (flat (k2, l),
//      two adjacent lanes of L a 16-byte read for lines up to 64),
//      transforms them and stores them from registers (paired stores
//      where L is even), with the split cluster barrier at the end.
// At (64, 128) every shared access of the three steps is free of bank
// conflicts, a block holds 4096 elements (32 KB, 256 threads) and several
// blocks share an SM, so one block's load overlaps another's lines.
// The tile, its load and the split barrier live in mid_line.cuh, beside
// K6's generic-radix line form (mid_mixed_kernel; kernels/mid_pair_fft.py:
// form mirrors mixed_pair), the same three steps on the same tile for
// pairs whose axes are r 2^a (r in 1, 3, 5, 7, 15) up to 240, or 256,
// and not both powers of two up to 128: the odd factor in registers, then
// the power-of-two sub-lines on the shuffle exchange (mid_line.cuh).
//
// The stage form (cube_fft_kernel), for every other cube in the envelope
// (odd radices, axes above 64) and K6's other pairs (mid_pair_fft_kernel:
// primes 11 to 31, factors 9 and 25, an axis above 256, a tile that needs
// more than 16 blocks at 8 lanes of L, tiles of 4 lanes of L): the shared
// Stockham stages (fft_stages.cuh) over the tile. Block b loads its slabs
// (K5: one contiguous run, written transposed (n2, n3) -> (n3, n2); K6:
// rows of `lanes` contiguous elements, the ragged end of L masked to
// zeros), runs n2, permutes each slab back and runs n3 (K6: n2 along rows
// (slab, lane)); after cluster.sync() it gathers its n1-columns as rows of
// n1 into its own tile, cluster.sync() again, runs the n1 stages and
// stores. A thread holds at most 8 values in any phase (kPer = 8): at 1024
// threads a block has 64 registers a thread. A block of more than 8192
// elements so works in two register passes: the stages run in chunks of
// whole rows, and a permutation or the gather parks its second pass in a
// spare shared region (70 KB at 16384). Every index is split by
// multiply-and-shift division (Div). The host picks C so that a block
// holds at most 2048 elements where it can (kernels/cube_fft.py:
// pick_cluster): small blocks share an SM.
//
// Known costs (PERF.md; tools/cluster_phases.py times each phase of both
// forms and other line-form geometries): a 64^3 cube needs C = 16 blocks,
// one block an SM, so a block's load, exchange and store overlap only
// other SMs' work, and 7 clusters fit the H100 (112 of 132 SMs); n1 values
// come 15/16 from other SMs; the line form's bf16 stores fill half
// sectors. 256 or 1024 threads of 16 values, or 512 of 32, measured slower
// at 64^3, and so did two forms that overlap more (the next round's reads
// issued before this round's transforms; a persistent grid of the resident
// clusters that reads the next cube while the cluster drains): both took
// more registers than this one's 80. In the stage form the
// block-wide stages synchronize the block at each stage, and the slab
// transpose and the n1-row writes are 4-way bank conflicts.

#include <climits>
#include <cooperative_groups.h>
#include <type_traits>

#include "fft_stages.cuh"
#include "line_fft.cuh"
#include "mid_line.cuh"

namespace cg = cooperative_groups;
using namespace tpufft_fft;
using namespace tpufft_line;
using namespace tpufft_mid;

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

// ---------------------------------------------------------------------------
// The line form of the cube kernel (the header's first form).
// ---------------------------------------------------------------------------

constexpr int kLineThreads = 512;  // threads of a line-form block, at most
constexpr int kLineSlabPad = 8;    // float2 between slabs of the tile

// The tile of a line-form block: `slabs` slabs of n2 rows of n3, rows at
// pitch `row`, slabs at pitch `slab` (float2). The pads keep the three
// phases' shared accesses free of bank conflicts at 64^3 (the header).
struct LineTile {
  int row, slab;
  __host__ __device__ LineTile(int n2, int n3)
      : row(n3 + (n3 >= 32 ? 4 : 2)), slab(n2 * row + kLineSlabPad) {}
};

// Where a thread's task of round `it` lies: its warp task w, place l and
// slot c.
template <int N>
struct Task {
  int w, l, c;
  __device__ __forceinline__ explicit Task(int it) {
    const int t = it * (int)blockDim.x + (int)threadIdx.x;
    w = t >> 5;
    l = (t & 31) / Line<N>::W;
    c = (t & 31) % Line<N>::W;
  }
};

__device__ __forceinline__ void store_pair(float* p, int64_t i, float a,
                                           float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int64_t i,
                                           float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

// Phase 1: the n3 rows of the block's slabs, `rows` = slabs * n2 of them,
// from device memory (the run from src0) into the tile. Line k of a
// thread is row w W K + c + W k.
template <int N, typename T, bool kFused>
__device__ __forceinline__ void line_rows(const T* __restrict__ xr,
                                          const T* __restrict__ xi,
                                          float2* tile, const LineTile& at,
                                          const float2* __restrict__ tw,
                                          int64_t src0, int rows, int n2,
                                          int rounds, bool inv) {
  using L = Line<N>;
  const int n2_shift = __ffs(n2) - 1;
  for (int it = 0; it < rounds; ++it) {
    const Task<N> tk(it);
    float2 v[L::K][L::V];
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int r = tk.w * (L::W * L::K) + tk.c + L::W * k;
#pragma unroll
      for (int j = 0; j < L::V; ++j) {
        v[k][j] = make_float2(0.f, 0.f);
        if (r < rows) {
          const int i = L::in(tk.l, j);
          int64_t g = src0 + (int64_t)r * N + i;
          if (kFused) g = fused_index(g, i);
          v[k][j] = make_float2(load_f(xr, g), load_f(xi, g));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < L::K; ++k) line_fft<N>(v[k], tk.l, tw, inv);
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int r = tk.w * (L::W * L::K) + tk.c + L::W * k;
      if (r < rows) {
        const int j = r >> n2_shift, k2 = r & (n2 - 1);
        float2* row = tile + j * at.slab + k2 * at.row;
#pragma unroll
        for (int q = 0; q < L::V; ++q) row[L::out(tk.l, q)] = v[k][q];
      }
    }
  }
}

// Phase 2: the n2 columns of every slab, `lines` = slabs * n3 of them, in
// place in the tile. Line k of a thread is column w W K + c + W k.
template <int N>
__device__ __forceinline__ void line_cols(float2* tile, const LineTile& at,
                                          const float2* __restrict__ tw,
                                          int lines, int n3, int rounds,
                                          bool inv) {
  using L = Line<N>;
  const int n3_shift = __ffs(n3) - 1;
  for (int it = 0; it < rounds; ++it) {
    const Task<N> tk(it);
    float2 v[L::K][L::V];
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int line = tk.w * (L::W * L::K) + tk.c + L::W * k;
      const float2* col = tile + (line >> n3_shift) * at.slab +
                          (line & (n3 - 1));
#pragma unroll
      for (int j = 0; j < L::V; ++j)
        v[k][j] = line < lines ? col[L::in(tk.l, j) * at.row]
                               : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < L::K; ++k) line_fft<N>(v[k], tk.l, tw, inv);
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int line = tk.w * (L::W * L::K) + tk.c + L::W * k;
      if (line < lines) {
        float2* col = tile + (line >> n3_shift) * at.slab + (line & (n3 - 1));
#pragma unroll
        for (int q = 0; q < L::V; ++q) col[L::out(tk.l, q) * at.row] = v[k][q];
      }
    }
  }
}

// Phase 3: the block's `cols` n1-columns (flat (k2, k3) positions
// [rank cols, rank cols + cols), an even count), read from the cluster's
// tiles, transformed and stored to device memory from registers; ends
// after the cluster barrier. Lines k and k + 1 (k even) of a thread are the
// adjacent columns w W K + c K + k and + 1: one 16-byte shared read a
// value pair and one paired store a plane.
template <int N, typename T, bool kFused>
__device__ __forceinline__ void line_n1(cg::cluster_group& cluster,
                                        float2* tile, const LineTile& at,
                                        T* __restrict__ yr,
                                        T* __restrict__ yi,
                                        const float2* __restrict__ tw,
                                        int64_t base, int rank, int cols,
                                        int slabs, int n3, int area,
                                        int rounds, bool inv, float scale) {
  using L = Line<N>;
  static_assert(L::K % 2 == 0, "columns go in pairs");
  const int n3_shift = __ffs(n3) - 1, slab_shift = __ffs(slabs) - 1;
  for (int it = 0; it < rounds; ++it) {
    const Task<N> tk(it);
    float2 v[L::K][L::V];
#pragma unroll
    for (int k = 0; k < L::K; k += 2) {
      const int q = tk.w * (L::W * L::K) + tk.c * L::K + k;
      const int col = rank * cols + q;
      const int off = (col >> n3_shift) * at.row + (col & (n3 - 1));
#pragma unroll
      for (int j = 0; j < L::V; ++j) {
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < cols) {
          const int k1 = L::in(tk.l, j);
          const float2* src = cluster.map_shared_rank(tile, k1 >> slab_shift);
          p = *reinterpret_cast<const float4*>(
              src + (k1 & (slabs - 1)) * at.slab + off);
        }
        v[k][j] = make_float2(p.x, p.y);
        v[k + 1][j] = make_float2(p.z, p.w);
      }
    }
    if (it == rounds - 1) cluster_arrive();  // the last remote read is done
#pragma unroll
    for (int k = 0; k < L::K; ++k) line_fft<N>(v[k], tk.l, tw, inv);
#pragma unroll
    for (int k = 0; k < L::K; k += 2) {
      const int q = tk.w * (L::W * L::K) + tk.c * L::K + k;
      if (q < cols) {
        const int col = rank * cols + q;
#pragma unroll
        for (int r = 0; r < L::V; ++r) {
          int64_t g = base + (int64_t)L::out(tk.l, r) * area + col;
          if (kFused) g = fused_index(g, col & (n3 - 1));
          store_pair(yr, g, v[k][r].x * scale, v[k + 1][r].x * scale);
          store_pair(yi, g, v[k][r].y * scale, v[k + 1][r].y * scale);
        }
      }
    }
  }
  cluster_wait();
}

// Lanes of a line-form share: every phase takes ceil(share / (32
// kLineValues)) warp tasks (a warp holds 32 kLineValues values).
__host__ __device__ inline int line_lanes(int share) {
  constexpr int warp = 32 * kLineValues;
  return (share + warp - 1) / warp * 32;
}

// Rounds of a line-form block of `threads` threads over a share.
__host__ __device__ inline int line_rounds(int share, int threads) {
  return (line_lanes(share) + threads - 1) / threads;
}

// K5/K16, the line form. Cluster c transforms cube c; block `rank` holds
// slabs [rank slabs, rank slabs + slabs) of n1 (one contiguous run of the
// planes) and, after the exchange, transforms the n1-columns [rank cols,
// rank cols + cols). kFused (K16): fused storage, h = n3.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kLineThreads, 1)
cube_line_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ yr, T* __restrict__ yi,
                 const float2* __restrict__ tw1,
                 const float2* __restrict__ tw2,
                 const float2* __restrict__ tw3, int n1, int n2, int n3,
                 int csize, int inverse, float scale) {
  extern __shared__ __align__(16) float2 tpufft_line_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float2* tile = tpufft_line_smem;
  const int area = n2 * n3, slabs = n1 / csize;
  const int share = slabs * area, cols = area / csize;
  const int rank = (int)cluster.block_rank();
  const int rounds = line_rounds(share, blockDim.x);
  const int64_t base = (int64_t)(blockIdx.x / csize) * n1 * area;
  const bool inv = inverse != 0;
  const LineTile at(n2, n3);
  with_length(n3, [&](auto n) {
    line_rows<decltype(n)::value, T, kFused>(
        xr, xi, tile, at, tw3, base + (int64_t)rank * share, slabs * n2, n2,
        rounds, inv);
  });
  __syncthreads();
  with_length(n2, [&](auto n) {
    line_cols<decltype(n)::value>(tile, at, tw2, slabs * n3, n3, rounds,
                                  inv);
  });
  cluster.sync();
  with_length(n1, [&](auto n) {
    line_n1<decltype(n)::value, T, kFused>(cluster, tile, at, yr, yi, tw1,
                                           base, rank, cols, slabs, n3, area,
                                           rounds, inv, scale);
  });
}

// ---------------------------------------------------------------------------
// The line form of K6 (the header's third form).
// ---------------------------------------------------------------------------

constexpr int kMidThreads = 256; // threads of a mid-pair line-form block

// Step 2: the n2 lines (slab j, lane l), `lines` = slabs kMidLanes of
// them, in place in the tile. Line k of a thread is w W K + c + W k.
template <int N>
__device__ __forceinline__ void mid_line_n2(float2* tile,
                                            const MidTile& at,
                                            const float2* __restrict__ tw,
                                            int lines, int rounds, bool inv) {
  using Ln = Line<N>;
  for (int it = 0; it < rounds; ++it) {
    const Task<N> tk(it);
    float2 v[Ln::K][Ln::V];
#pragma unroll
    for (int k = 0; k < Ln::K; ++k) {
      const int line = tk.w * (Ln::W * Ln::K) + tk.c + Ln::W * k;
      const int j = line / kMidLanes, l = line % kMidLanes;
#pragma unroll
      for (int q = 0; q < Ln::V; ++q)
        v[k][q] = line < lines ? tile[at.at(j, Ln::in(tk.l, q), l)]
                               : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < Ln::K; ++k) line_fft<N>(v[k], tk.l, tw, inv);
#pragma unroll
    for (int k = 0; k < Ln::K; ++k) {
      const int line = tk.w * (Ln::W * Ln::K) + tk.c + Ln::W * k;
      if (line < lines) {
        const int j = line / kMidLanes, l = line % kMidLanes;
#pragma unroll
        for (int q = 0; q < Ln::V; ++q)
          tile[at.at(j, Ln::out(tk.l, q), l)] = v[k][q];
      }
    }
  }
}

// One output element pair (lanes l, l + 1 of L, l even) or, for K = 1
// lines, one element: paired stores where L is even and the planes take
// them, else masked single stores.
template <typename T>
__device__ __forceinline__ void mid_store2(T* __restrict__ yr,
                                           T* __restrict__ yi, int64_t g,
                                           int l, int64_t left, bool paired,
                                           float2 a, float2 b, float scale) {
  if (paired) {   // l and L even: l < left covers l + 1
    if (l < left) {
      store_pair(yr, g, a.x * scale, b.x * scale);
      store_pair(yi, g, a.y * scale, b.y * scale);
    }
    return;
  }
  if (l < left) {
    store_f(yr, g, a.x * scale);
    store_f(yi, g, a.y * scale);
  }
  if (l + 1 < left) {
    store_f(yr, g + 1, b.x * scale);
    store_f(yi, g + 1, b.y * scale);
  }
}

// Step 3: the block's `cols` n1-columns (flat (k2, l) positions [rank cols,
// rank cols + cols), an even count), read from the cluster's tiles,
// transformed and stored to device memory from registers, the scale
// applied once; ends after the cluster barrier. For N <= 64 (K even)
// lines k and k + 1 of a thread are the adjacent columns w W K + c K + k
// and + 1 (lanes l, l + 1 of L): one 16-byte shared read a value pair and
// a paired store a plane, 8 consecutive lanes of L a row in a warp store
// at N = 64. A 128-line (K = 1) takes one column.
template <int N, typename T>
__device__ __forceinline__ void mid_line_n1(
    cg::cluster_group& cluster, float2* tile, const MidTile& at,
    T* __restrict__ yr, T* __restrict__ yi, const float2* __restrict__ tw,
    int64_t out0, int64_t L, int64_t left, bool paired, int rank, int cols,
    int slabs, int n2, int rounds, bool inv, float scale) {
  using Ln = Line<N>;
  constexpr int kStep = Ln::K % 2 == 0 ? 2 : 1;
  const int slab_shift = __ffs(slabs) - 1;
  for (int it = 0; it < rounds; ++it) {
    const Task<N> tk(it);
    float2 v[Ln::K][Ln::V];
#pragma unroll
    for (int k = 0; k < Ln::K; k += kStep) {
      const int q = tk.w * (Ln::W * Ln::K) + tk.c * Ln::K + k;
      const int col = rank * cols + q;
      const int k2 = col / kMidLanes, l = col % kMidLanes;
#pragma unroll
      for (int j = 0; j < Ln::V; ++j) {
        const int k1 = Ln::in(tk.l, j);
        const float2* src = cluster.map_shared_rank(tile, k1 >> slab_shift) +
                            at.at(k1 & (slabs - 1), k2, l);
        if constexpr (kStep == 2) {
          float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < cols) p = *reinterpret_cast<const float4*>(src);
          v[k][j] = make_float2(p.x, p.y);
          v[k + 1][j] = make_float2(p.z, p.w);
        } else {
          v[k][j] = q < cols ? *src : make_float2(0.f, 0.f);
        }
      }
    }
    if (it == rounds - 1) cluster_arrive();  // the last remote read is done
#pragma unroll
    for (int k = 0; k < Ln::K; ++k) line_fft<N>(v[k], tk.l, tw, inv);
#pragma unroll
    for (int k = 0; k < Ln::K; k += kStep) {
      const int q = tk.w * (Ln::W * Ln::K) + tk.c * Ln::K + k;
      if (q >= cols) continue;
      const int col = rank * cols + q;
      const int k2 = col / kMidLanes, l = col % kMidLanes;
#pragma unroll
      for (int r = 0; r < Ln::V; ++r) {
        const int64_t g =
            out0 + ((int64_t)Ln::out(tk.l, r) * n2 + k2) * L + l;
        if constexpr (kStep == 2) {
          mid_store2(yr, yi, g, l, left, paired, v[k][r], v[k + 1][r], scale);
        } else if (l < left) {
          store_f(yr, g, v[k][r].x * scale);
          store_f(yi, g, v[k][r].y * scale);
        }
      }
    }
  }
  cluster_wait();
}

// K6, the line form. Cluster c transforms tile c = (plane p, lanes [l0,
// l0 + kMidLanes)) of the (pre, n1, n2, L) planes; block `rank` holds
// rows k1 in [rank slabs, rank slabs + slabs) and, after the exchange, the
// n1-columns [rank cols, rank cols + cols) of flat (k2, l). Lanes at or
// past L load as zeros and are never stored. paired: L even and the
// output planes aligned for paired stores; quads: L % 4 == 0 and the
// input planes aligned for 4-element loads.
template <typename T>
__global__ void __launch_bounds__(kMidThreads, 4)
mid_pair_line_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     T* __restrict__ yr, T* __restrict__ yi,
                     const float2* __restrict__ tw1,
                     const float2* __restrict__ tw2, int n1, int n2,
                     int64_t L, int csize, int paired, int quads,
                     int inverse, float scale) {
  extern __shared__ __align__(16) float2 tpufft_mid_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float2* tile = tpufft_mid_smem;
  const int slabs = n1 / csize;
  const int share = slabs * n2 * kMidLanes;
  const int cols = n2 * kMidLanes / csize;
  const int rank = (int)cluster.block_rank();
  const int rounds = line_rounds(share, blockDim.x);
  const int64_t tile_id = blockIdx.x / csize;
  const int64_t ltiles = (L + kMidLanes - 1) / kMidLanes;
  const int64_t p = tile_id / ltiles;
  const int64_t l0 = (tile_id - p * ltiles) * kMidLanes;
  const int64_t left = L - l0;   // lanes of this tile inside L
  const bool inv = inverse != 0;
  const MidTile at(n2);
  const int64_t row0 = (p * n1 + (int64_t)rank * slabs) * n2;
  if (quads)
    mid_line_load4(xr + l0, xi + l0, tile, at, row0, L, left, slabs * n2,
                   Pow2Rows(n2));
  else
    mid_line_load(xr + l0, xi + l0, tile, at, row0, L, left, slabs * n2,
                  Pow2Rows(n2));
  __syncthreads();
  with_length128(n2, [&](auto n) {
    mid_line_n2<decltype(n)::value>(tile, at, tw2, slabs * kMidLanes,
                                    rounds, inv);
  });
  cluster.sync();
  with_length128(n1, [&](auto n) {
    mid_line_n1<decltype(n)::value, T>(
        cluster, tile, at, yr, yi, tw1, p * n1 * n2 * L + l0, L, left,
        paired != 0, rank, cols, slabs, n2, rounds, inv, scale);
  });
}

// ---------------------------------------------------------------------------
// The stage form of the cube kernel, and K6 (the header's second form).
// ---------------------------------------------------------------------------

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

// How many clusters of `kernel` the device can hold at once (0: none).
template <typename Kernel>
int active_clusters(Kernel kernel, const Shape& s, int csize, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      cluster_config(kernel, s.threads, s.smem, csize, csize, 0, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// Launch `kernel` over pre clusters of csize blocks of geometry s.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, const Shape& s, long long pre, int csize,
                    cudaStream_t stream, Args... args) {
  const long long blocks = pre * csize;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err =
      cluster_config(kernel, s.threads, s.smem, blocks, csize, stream, &attr,
                     &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)cudaGetLastError();
}

// Does the cube take the line form: every axis a power of two from 2 to
// 64, and an even number of n1-columns a block (they go in pairs)?
// kernels/cube_fft.py:form mirrors it.
inline bool line_cube(int n1, int n2, int n3, int csize) {
  const auto ok = [](int n) { return n >= 2 && n <= 64 && !(n & (n - 1)); };
  return ok(n1) && ok(n2) && ok(n3) && (n2 * n3 / csize) % 2 == 0;
}

// The line form's block: enough threads for the share's warp tasks, at
// most kLineThreads, and the padded tile (LineTile).
inline Shape line_shape(int n1, int n2, int n3, int csize) {
  Shape s;
  const int slabs = n1 / csize, share = slabs * n2 * n3;
  const int lanes = line_lanes(share);
  s.threads = lanes < kLineThreads ? lanes : kLineThreads;
  s.span = 0;
  s.smem = (size_t)slabs * LineTile(n2, n3).slab * sizeof(float2);
  return s;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// K5 (kFused off: xr, xi, yr, yi are the four planes) or K16 (on: xr and
// yr are the fused input and output, xi and yi unused), for the checked
// cube geometry s of the stage form: the line form where line_cube holds
// and the outputs take paired stores, else the stage form.
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
  const auto* w1 = static_cast<const float2*>(tw1);
  const auto* w2 = static_cast<const float2*>(tw2);
  const auto* w3 = static_cast<const float2*>(tw3);
  if (line_cube(p1.n, p2.n, p3.n, csize) && aligned(y, 2 * sizeof(T)) &&
      aligned(y_im, 2 * sizeof(T)))
    return launch_clusters(cube_line_kernel<T, kFused>,
                           line_shape(p1.n, p2.n, p3.n, csize), pre, csize,
                           stream, x, x_im, y, y_im, w1, w2, w3, p1.n, p2.n,
                           p3.n, csize, inverse, scale);
  if (s.threads <= kPackedShare / kPer)
    return launch_clusters(cube_fft_kernel<T, 512, 2, kFused>, s, pre, csize,
                           stream, x, x_im, y, y_im, w1, w2, w3, p1, p2, p3,
                           csize, inverse, scale);
  return launch_clusters(cube_fft_kernel<T, 1024, 1, kFused>, s, pre, csize,
                         stream, x, x_im, y, y_im, w1, w2, w3, p1, p2, p3,
                         csize, inverse, scale);
}

template <typename T, int kThreads, int kMinBlocks>
int launch_mid(const void* xr, const void* xi, void* yr, void* yi,
               const void* tw1, const void* tw2, long long pre,
               const Radices& p1, const Radices& p2, long long L, int lanes,
               int csize, const Shape& s, int inverse, float scale,
               cudaStream_t stream) {
  return launch_clusters(mid_pair_fft_kernel<T, kThreads, kMinBlocks>, s,
                         pre * ((L + lanes - 1) / lanes), csize, stream,
                         static_cast<const T*>(xr), static_cast<const T*>(xi),
                         static_cast<T*>(yr), static_cast<T*>(yi),
                         static_cast<const float2*>(tw1),
                         static_cast<const float2*>(tw2), p1, p2,
                         (int64_t)L, lanes, csize, inverse, scale);
}

// Does the mid pair take the line form: n1 and n2 powers of two from 2 to
// 128, tiles of kMidLanes lanes of L, a share of at most 16384 elements
// and an even number of n1-columns a block (they go in pairs)?
// kernels/mid_pair_fft.py:form mirrors it.
inline bool line_mid(int n1, int n2, int lanes, int csize) {
  const auto ok = [](int n) { return n >= 2 && n <= 128 && !(n & (n - 1)); };
  return ok(n1) && ok(n2) && lanes == kMidLanes && cluster_ok(csize) &&
         n1 % csize == 0 && (n1 / csize) * n2 * kMidLanes <= kMaxN &&
         (n2 * kMidLanes / csize) % 2 == 0;
}

// The mid-pair line form's block: enough threads for the share's warp
// tasks, at most kMidThreads, and the padded tile (MidTile).
inline Shape mid_line_shape(int n1, int n2, int csize) {
  Shape s;
  const int slabs = n1 / csize, share = slabs * n2 * kMidLanes;
  const int lanes = line_lanes(share);
  s.threads = lanes < kMidThreads ? lanes : kMidThreads;
  s.span = 0;
  s.smem = (size_t)slabs * MidTile(n2).slab * sizeof(float2);
  return s;
}

template <typename T>
int launch_mid_line(const void* xr, const void* xi, void* yr, void* yi,
                    const void* tw1, const void* tw2, long long pre, int n1,
                    int n2, long long L, int csize, int inverse, float scale,
                    cudaStream_t stream) {
  const int paired = L % 2 == 0 && aligned(yr, 2 * sizeof(T)) &&
                     aligned(yi, 2 * sizeof(T));
  const int quads = L % 4 == 0 && aligned(xr, 4 * sizeof(T)) &&
                    aligned(xi, 4 * sizeof(T));
  return launch_clusters(mid_pair_line_kernel<T>,
                         mid_line_shape(n1, n2, csize),
                         pre * ((L + kMidLanes - 1) / kMidLanes), csize,
                         stream, static_cast<const T*>(xr),
                         static_cast<const T*>(xi), static_cast<T*>(yr),
                         static_cast<T*>(yi), static_cast<const float2*>(tw1),
                         static_cast<const float2*>(tw2), n1, n2, (int64_t)L,
                         csize, paired, quads, inverse, scale);
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

template <typename T, bool kFused>
int cube_clusters_typed(int n1, int n2, int n3, int csize, const Shape& s,
                        int* out) {
  if (line_cube(n1, n2, n3, csize))
    return active_clusters(cube_line_kernel<T, kFused>,
                           line_shape(n1, n2, n3, csize), csize, out);
  if (s.threads <= kPackedShare / kPer)
    return active_clusters(cube_fft_kernel<T, 512, 2, kFused>, s, csize, out);
  return active_clusters(cube_fft_kernel<T, 1024, 1, kFused>, s, csize, out);
}

template <bool kFused>
int cube_clusters(int n1, int n2, int n3, int csize, int bf16, int* out) {
  const Shape s = cube_shape(n1, n2, n3, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  return bf16 ? cube_clusters_typed<__nv_bfloat16, kFused>(n1, n2, n3, csize,
                                                           s, out)
              : cube_clusters_typed<float, kFused>(n1, n2, n3, csize, s, out);
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
// chunks as for the cube. Where line_mid holds (powers of two to 128, 8
// lanes) the line form runs, where mixed_pair holds (mid_line.cuh: both
// axes on its lists, 8 lanes) the generic-radix form, else the stage
// form. Returns 0 or the CUDA error code.
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (line_mid(n1, n2, lanes, csize)) {
    if (pre == 0) return 0;
    if (bf16)
      return launch_mid_line<__nv_bfloat16>(xr, xi, yr, yi, tw1, tw2, pre, n1,
                                            n2, L, csize, inverse, scale, st);
    return launch_mid_line<float>(xr, xi, yr, yi, tw1, tw2, pre, n1, n2, L,
                                  csize, inverse, scale, st);
  }
  if (mixed_pair(n1, n2, lanes, csize)) {
    if (pre == 0) return 0;
    const size_t quad = 4 * (bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
    const int quads = L % 4 == 0 && aligned(xr, quad) && aligned(xi, quad);
    return launch_mixed({xr, xi, yr, yi, tw1, tw2, pre, n1, n2, L, csize,
                         bf16 != 0, quads, inverse, scale, st});
  }
  const Shape s = mid_shape(n1, n2, lanes, csize);
  if (s.threads == 0) return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
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
  if (line_mid(n1, n2, lanes, csize)) {
    const Shape s = mid_line_shape(n1, n2, csize);
    return bf16 ? active_clusters(mid_pair_line_kernel<__nv_bfloat16>, s,
                                  csize, out)
                : active_clusters(mid_pair_line_kernel<float>, s, csize, out);
  }
  if (mixed_pair(n1, n2, lanes, csize))
    return mixed_clusters(n1, n2, csize, out);
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
