// Batched C2C FFT along a strided (non-minor) axis, with plain C entry
// points for ctypes (tpufft_torch/kernels/inner_fft.py and fused_fft.py bind
// and check them).
//
// Replaces four Pallas TPU kernels of tpufft/kernels/mxu_fft.py:
// - _build_inner: the middle axis of a (pre, n, L) view, L contiguous;
// - _build_inner_nd: dim 0 of a (pre*n, M, L) view, optionally multiplied
//   by an (n, M) complex twiddle before the store (with_tw, pass 1 of the
//   two-pass split of a long axis);
// - _build_inner_fused and _build_inner_fused_m1 (K18, K19): the same axis
//   of a fused-storage (pre, n, M, 2L) array whose L-rows are [re | im]
//   (tpufft_strided_fft_fused; only the load and the store differ).
// On the H100 there is no (8, 128) lane tiling, so both views are the same
// memory: (pre, n, post) with post = M*L contiguous. One kernel serves
// both; the wrappers count the two separately. Contract as the minor-axis
// kernel's: f32 or bf16 storage, f32 arithmetic, a forward/inverse flag,
// one real scale applied once at the store, twiddles from a host f64 table.
//
// What bounds it on an H100: device-memory bandwidth, as for the minor
// axis (~3 flop/byte), plus the access pattern: the n values of one
// transform lie `post` elements apart.
//
// The kernel has three forms; launch_sized picks one by (n, post,
// storage), and tpufft_strided_line_geometry below tells
// kernels/inner_fft.py:form which. The line form (strided_line.cuh: n = r
// 2^a, r in {1, 3, 5}, from 8 to 2048, and 15 2^a from 30 to 1920, 25, 93
// and 1080, on post of at least 8 f32 or 16 bf16 columns; bf16 up to 1024)
// keeps each column line in registers and crosses shared memory once; the
// cluster line form (strided_long.cuh: f32 2160, 2560, 3072, 3840 and the
// three-factor lengths 4096 to 16384 of the minor axis; bf16 those and
// 1080, 1280, 1536, 1920, 2048) spreads a unit's tile over a thread-block
// cluster; their design notes are there. Every other launch runs the stage
// form below (strided_fft_kernel), e.g. n = 127 (a prime above 31), 2880
// or 4100; tpufft_strided_fft_stages runs it at every length, to compare
// the forms.
//
// The stage form: a block takes an (n, cols) tile - n strided rows, `cols`
// contiguous columns - and loads it with neighbouring threads on neighbouring
// columns (coalesced runs of cols elements), transposing it into shared memory
// as cols rows of length n. It runs the shared Stockham stages
// (fft_stages.cuh) on those rows and stores the tile back the same way. Every
// element crosses device memory once each way. The tile is (n, cols) with n *
// cols <= 4096 for n <= 1024 (512 threads, two or more blocks an SM, as the
// minor kernel packs short rows) and <= 16384 for longer n (1024 threads, up
// to 139 KB of shared memory, one block an SM). Measured on an H100 at 700 W,
// the small tiles ran 2.4x faster at n = 640 and 1.2x at n = 1024 than the
// large ones despite their narrower column runs (4 columns at n = 1024), and
// 1.4-1.7x slower at n = 2048 and 4096: with one block an SM nothing overlaps
// a block's load, stages and store. When post is narrower than a tile, one
// block takes several pre-slices.
//
// A swapped launch (tpufft_strided_fft_swapped, pass 1 of the two-pass
// split: with tw_nm, post = tw_m tw_l) writes output (p, k, m tw_l + l) to
// (p, m, k, l) of the (pre, tw_m, n, tw_l) order instead: the line forms
// with their kSwap instantiations (strided_line.cuh, which restages the
// unit through the tile where it can, and strided_long.cuh), the stage form
// with its runtime `swap` at the same store, lanes on consecutive columns.
// A swapped launch at n <= 32 runs the stage form.
//
// Known costs of the stage form:
// - at n = 16384 a tile is one column wide, so each load is a lone
//   4-byte access per row (the cluster form's units of 16 columns replace
//   it at the lengths of its lists);
// - writing the transposed tile into shared memory hits one bank with up
//   to 16 threads of a half-warp when n is a multiple of 16 (the stages'
//   pad() serves their own strides, not this one).

#include <climits>
#include <type_traits>

#include "fft_stages.cuh"
#include "strided_line.cuh"
#include "strided_long.cuh"

using namespace tpufft_fft;

namespace {

constexpr int kSmallTile = 4096;   // elements of a tile for n <= 1024
constexpr int kLargeTile = 16384;  // elements of a tile for longer n

struct Tile {
  int cols_log2;  // tile columns, a power of two
  int slabs;      // pre-slices per block (> 1 only when cols >= post)
  int per;        // complex values per thread (the kernel's kPer)
  int threads;
  size_t smem;
  long long col_tiles, blocks;
};

inline int log2_floor(long long x) {
  int k = 0;
  while ((2LL << k) <= x) ++k;
  return k;
}

inline Tile tile_for(long long pre, int n, long long post) {
  Tile t;
  const int cap = n <= 1024 ? kSmallTile : kLargeTile;
  t.per = cap == kSmallTile ? 8 : 16;
  int lg = log2_floor(cap / n);
  while (lg > 0 && (1LL << (lg - 1)) >= post) --lg;  // no wider than post
  t.cols_log2 = lg;
  const int cols = 1 << lg;
  t.slabs = 1;
  if (cols >= post) {
    long long s = cap / ((long long)n * cols);
    if (s > pre) s = pre;
    t.slabs = s < 1 ? 1 : (int)s;
  }
  const int elems = t.slabs * cols * n;
  t.threads = ((elems + t.per - 1) / t.per + 31) / 32 * 32;
  t.smem = (size_t)pad(elems) * sizeof(float2);
  t.col_tiles = (post + cols - 1) / cols;
  t.blocks = t.col_tiles * ((pre + t.slabs - 1) / t.slabs);
  return t;
}

// Block b takes slabs pre-slices starting at p0 and cols columns starting
// at c0 of the (pre, n, post) planes; shared row pp*cols + l holds column
// c0 + l of slice p0 + pp. Out-of-range slices and columns load zeros and
// are not stored. With tw_nm, output (k, c) is multiplied by
// tw_nm[k, c / tw_l] (an (n, tw_m) table) before the scale; with swap too,
// it is stored at (p, c / tw_l, k, c mod tw_l) of the (pre, tw_m, n, tw_l)
// order.
// kFused (K18, K19): the planes are fused storage (pre, n, M, 2L) with
// post = M * L logical columns and h = tw_l = L (fft_stages.cuh); logical
// column c = m*L + l lies at m*2L + l, so a tile's columns may span several
// m and never read an im half as re columns. tw_nm is null.
template <typename T, int kThreads, int kPer, int kMinBlocks, bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
strided_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                   T* __restrict__ yr, T* __restrict__ yi,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ tw_nm, int64_t pre, int post,
                   int tw_m, int tw_l, Radices plan, int cols_log2,
                   int slabs, int64_t col_tiles, int inverse, float scale,
                   int swap) {
  extern __shared__ float2 tpufft_strided_smem[];
  float2* buf = tpufft_strided_smem;
  const int n = plan.n;
  const int cols = 1 << cols_log2;
  const int64_t p0 = (int64_t)(blockIdx.x / col_tiles) * slabs;
  const int c0 = (int)(blockIdx.x % col_tiles) * cols;
  const int rows = slabs * cols;
  const int total = rows * n;
  float2 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.f, 0.f);
    if (e < total) {
      const int l = e & (cols - 1), t = e >> cols_log2;
      const int pp = t / n, kk = t - pp * n;
      const int64_t p = p0 + pp;
      const int c = c0 + l;
      if (p < pre && c < post) {
        int64_t g = (p * n + kk) * post + c;
        if (kFused) g = fused_index(g, c % tw_l);
        v[k] = make_float2(load_f(xr, g), load_f(xi, g));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) {
      const int l = e & (cols - 1), t = e >> cols_log2;
      const int pp = t / n, kk = t - pp * n;
      buf[pad((pp * cols + l) * n + kk)] = v[k];
    }
  }
  __syncthreads();
  run_stages<kPer>(buf, tw, plan, rows, inverse != 0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) {
      const int l = e & (cols - 1), t = e >> cols_log2;
      const int pp = t / n, kk = t - pp * n;
      const int64_t p = p0 + pp;
      const int c = c0 + l;
      if (p < pre && c < post) {
        float2 w = buf[pad((pp * cols + l) * n + kk)];
        if (!kFused && tw_nm != nullptr)
          w = cmul(w, __ldg(&tw_nm[kk * tw_m + c / tw_l]));
        int64_t g = (p * n + kk) * post + c;
        if (kFused) g = fused_index(g, c % tw_l);
        if (!kFused && swap)
          g = p * n * post + (int64_t)(c / tw_l) * n * tw_l +
              (int64_t)kk * tw_l + c % tw_l;
        store_f(yr, g, w.x * scale);
        store_f(yi, g, w.y * scale);
      }
    }
  }
}

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kFused>
int launch(const void* xr, const void* xi, void* yr, void* yi, const void* tw,
           const void* tw_nm, long long pre, long long post, int tw_m,
           long long tw_l, const Radices& plan, const Tile& t, int inverse,
           float scale, int swap, cudaStream_t stream) {
  auto* kernel = strided_fft_kernel<T, kThreads, kPer, kMinBlocks, kFused>;
  if (t.threads > kThreads || t.per != kPer) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, t.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)t.blocks, t.threads, t.smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(yr), static_cast<T*>(yi),
      static_cast<const float2*>(tw), static_cast<const float2*>(tw_nm),
      (int64_t)pre, (int)post, tw_m, (int)tw_l, plan, t.cols_log2, t.slabs,
      (int64_t)t.col_tiles, inverse, scale, swap);
  return (int)cudaGetLastError();
}

// The line form where line_geometry gives one (not the lines kernel for a
// swapped launch), else the cluster form where cluster_geometry does, else
// the stage form; `stages` forces the stage form (kept to compare the
// forms); `swap` (with tw_nm) the swapped store.
template <typename T, bool kFused>
int launch_sized(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw, const void* tw_nm, long long pre,
                 long long post, int tw_m, long long tw_l,
                 const Radices& plan, int inverse, float scale,
                 cudaStream_t stream, bool stages = false, int swap = 0) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const tpufft_strided::LineArgs args{
      xr, xi, yr, yi, tw, tw_nm, pre, post, tw_m, tw_l, inverse, scale,
      stream, swap};
  tpufft_strided::LineGeometry g;
  if (!stages && tpufft_strided::line_geometry(plan.n, post, bf16, &g) &&
      !(swap && g.n2 == 1))
    return tpufft_strided::launch_line<T, kFused>(args, g);
  tpufft_strided::ClusterGeometry cl;
  if (!stages && tpufft_strided::cluster_geometry(plan.n, post, bf16, &cl))
    return tpufft_strided::launch_cluster<T, kFused>(args, cl);
  const Tile t = tile_for(pre, plan.n, post);
  if (t.blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (t.per == 8)
    return launch<T, 512, 8, 2, kFused>(xr, xi, yr, yi, tw, tw_nm, pre, post,
                                        tw_m, tw_l, plan, t, inverse, scale,
                                        swap, stream);
  return launch<T, 1024, 16, 1, kFused>(xr, xi, yr, yi, tw, tw_nm, pre, post,
                                        tw_m, tw_l, plan, t, inverse, scale,
                                        swap, stream);
}

// K18/K19: (pre, n, M, 2L) fused storage, its two planes st and st + L
// (out and out + L), as the (pre, n, M * L) logical planes with h = L.
template <typename T>
int launch_fused(const void* st, void* out, const void* tw, long long pre,
                 long long M, long long L, const Radices& plan, int inverse,
                 float scale, cudaStream_t stream) {
  const T* x = static_cast<const T*>(st);
  T* y = static_cast<T*>(out);
  return launch_sized<T, true>(x, x + L, y, y + L, tw, nullptr, pre, M * L,
                               0, L, plan, inverse, scale, stream);
}

}  // namespace

namespace {

int strided_entry(const void* xr, const void* xi, void* yr, void* yi,
                  const void* tw, long long pre, int n, long long post,
                  const int* radices, int nstages, const void* tw_nm,
                  int tw_m, long long tw_l, int inverse, float scale,
                  int bf16, bool stages, void* stream, int swap = 0) {
  Radices plan;
  if (pre < 0 || post < 0 || post > INT_MAX ||
      !make_radices(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (tw_nm != nullptr && (tw_m < 1 || tw_l < 1 || tw_m * tw_l != post))
    return (int)cudaErrorInvalidValue;
  if (swap && tw_nm == nullptr) return (int)cudaErrorInvalidValue;
  if (pre == 0 || post == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_sized<__nv_bfloat16, false>(xr, xi, yr, yi, tw, tw_nm, pre,
                                              post, tw_m, tw_l, plan, inverse,
                                              scale, s, stages, swap);
  return launch_sized<float, false>(xr, xi, yr, yi, tw, tw_nm, pre, post,
                                    tw_m, tw_l, plan, inverse, scale, s,
                                    stages, swap);
}

}  // namespace

// Transforms axis 1 of the (pre, n, post) planes xr/xi into yr/yi (f32,
// or bf16 when bf16 != 0) on `stream`, a stream of the current device.
// tw holds the n complex f32 values exp(-+2 pi i k / n) for the direction;
// radices[0:nstages] multiply to n, each 2, 4, 8 or an odd value up to 127.
// tw_nm is null, or an (n, tw_m) complex f32 table with tw_m * tw_l = post
// that multiplies output (k, m * tw_l + l) by tw_nm[k, m] before the
// scale. Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_strided_fft(const void* xr, const void* xi, void* yr,
                                  void* yi, const void* tw, long long pre,
                                  int n, long long post, const int* radices,
                                  int nstages, const void* tw_nm, int tw_m,
                                  long long tw_l, int inverse, float scale,
                                  int bf16, void* stream) {
  return strided_entry(xr, xi, yr, yi, tw, pre, n, post, radices, nstages,
                       tw_nm, tw_m, tw_l, inverse, scale, bf16, false,
                       stream);
}

// The same transform on the stage form at every length, kept to compare
// the forms; arguments and result as for tpufft_strided_fft.
extern "C" int tpufft_strided_fft_stages(
    const void* xr, const void* xi, void* yr, void* yi, const void* tw,
    long long pre, int n, long long post, const int* radices, int nstages,
    const void* tw_nm, int tw_m, long long tw_l, int inverse, float scale,
    int bf16, void* stream) {
  return strided_entry(xr, xi, yr, yi, tw, pre, n, post, radices, nstages,
                       tw_nm, tw_m, tw_l, inverse, scale, bf16, true, stream);
}

// Pass 1 of the two-pass split: the transform of tpufft_strided_fft with
// tw_nm (required) whose output (p, k, m tw_l + l) is stored at (p, m, k,
// l) of yr/yi in the (pre, tw_m, n, tw_l) order; the form the launch picks
// (stages = 0) or the stage form (stages != 0, kept to compare the forms).
// Arguments and result otherwise as for tpufft_strided_fft.
extern "C" int tpufft_strided_fft_swapped(
    const void* xr, const void* xi, void* yr, void* yi, const void* tw,
    long long pre, int n, long long post, const int* radices, int nstages,
    const void* tw_nm, int tw_m, long long tw_l, int inverse, float scale,
    int bf16, int stages, void* stream) {
  return strided_entry(xr, xi, yr, yi, tw, pre, n, post, radices, nstages,
                       tw_nm, tw_m, tw_l, inverse, scale, bf16, stages != 0,
                       stream, 1);
}

// K18 (M > 1) and K19 (M == 1): axis 1 of the (pre, n, M, 2L) array st in
// fused storage, each L-row [re(0..L-1) | im(0..L-1)], into `out` of the
// same shape; tw, radices, inverse, scale, bf16 and stream as for
// tpufft_strided_fft; M, L >= 1 and M * L <= INT_MAX. Returns 0 or the
// CUDA error code of the launch.
extern "C" int tpufft_strided_fft_fused(const void* st, void* out,
                                        const void* tw, long long pre, int n,
                                        long long M, long long L,
                                        const int* radices, int nstages,
                                        int inverse, float scale, int bf16,
                                        void* stream) {
  Radices plan;
  if (pre < 0 || M < 1 || L < 1 || M > INT_MAX / L ||
      !make_radices(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (pre == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fused<__nv_bfloat16>(st, out, tw, pre, M, L, plan, inverse,
                                       scale, s);
  return launch_fused<float>(st, out, tw, pre, M, L, plan, inverse, scale,
                             s);
}

// The form a launch of n-long lines over post columns (M L on fused
// storage) in f32 (bf16 = 0) or bf16 storage runs: 1 and out[0:5] = {N1,
// N2, C, threads, shared-memory bytes} of the line form (N2 = 1: one line a
// lane, no tile); 2 and out[0:7] = {N1, N2, C, threads, shared-memory bytes
// a block, N3, Q} of the cluster form; or 0 for the stage form. n must lie
// in the kernel's envelope.
extern "C" int tpufft_strided_line_geometry(int n, long long post, int bf16,
                                            int* out) {
  tpufft_strided::LineGeometry g;
  if (tpufft_strided::line_geometry(n, post, bf16 != 0, &g)) {
    out[0] = g.n1;
    out[1] = g.n2;
    out[2] = 1 << g.cols_log2;
    out[3] = g.threads;
    out[4] = (int)g.smem;
    return 1;
  }
  tpufft_strided::ClusterGeometry c;
  if (!tpufft_strided::cluster_geometry(n, post, bf16 != 0, &c)) return 0;
  const int row[7] = {c.n1, c.n2, tpufft_strided::kLongCols, c.threads,
                      (int)c.smem, c.n3, c.q};
  for (int i = 0; i < 7; ++i) out[i] = row[i];
  return 2;
}
