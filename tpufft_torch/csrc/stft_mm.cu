// The short-time Fourier kernels, with plain C entry points for ctypes
// (tpufft_torch/kernels/stft_mm.py binds and checks them).
//
// Replaces three Pallas TPU kernels of tpufft/kernels/mxu_fft.py:
//   K13 build_stft_overlap: a real signal (batch, n_sig) -> spectrum planes
//       (batch, nseg, m1); frame s of row b is f = x[b, s hop : s hop +
//       nperseg], and its spectrum is
//         y[b, s, k] = c[k] rDFT_nfft(w . (f - A pinv(A) f))[k],
//       the detrend (A = [1] or [1, j - (nperseg-1)/2]), the real window w,
//       the zero-pad to nfft, the real DFT and a per-bin complex factor c
//       (the scale, a phase shift, the onesided2X doubling). The TPU kernel
//       and the callers' backward fold all of it into one (nperseg, m1)
//       matrix M = D diag(w) V diag(c);
//   K14 build_istft_ola: spectrum planes (batch, nseg, m1) -> the
//       overlap-added signal (batch, (nseg + K - 1) hop), K = nperseg / hop;
//       segment s contributes Zr Ar + Zi Ai (A is (m1, nperseg)) at s hop;
//       unnormalised (the window-sum division stays with the caller);
//   K15 build_welch_accum: the sum over segments of |F_s M|^2 (welch), or
//       of conj(F_s M) (G_s M) as two planes (csd), -> (batch, m1); the
//       per-segment spectra never reach device memory.
// Signals and spectra are f32 or bf16 (computed in f32), tables and
// results f32, all row-major and contiguous.
//
// K13 on an H100 is bound by device-memory bytes: one read of the signal
// and one write of the planes (at nperseg 256, hop 128: 4 bytes in, 8.1
// bytes out per sample) against ~2.5 nfft log2 nfft flops a frame. The
// dense product with M costs 4 nperseg flops a bin, ~32x the FFT's at
// nfft = 256, which bounded the earlier form by the FP32 peak above
// torch.stft's time. So K13 is an FFT: a block takes one row and a run of
// `frames` consecutive frames, copies the run's span, (frames - 1) hop +
// nperseg samples, into shared memory once (16-byte cp.async where the
// chunk lies inside the signal), reads the overlapping frames from there,
// takes each frame's mean and first moment by a warp reduction, windows and
// zero-pads it into the stage buffer as K7 packs a row (even nfft: m =
// nfft/2 complex values x[2j] + i x[2j+1]; odd nfft: the row with a zero
// imaginary part), runs K7's stages (fft_stages.cuh), untangles the bins
// (real_fft.cuh), multiplies by c and stores the block's frames as one
// contiguous, coalesced run of each plane. A block takes half the rows K1
// packs of its stage length (minor_fft.cuh:launch_geometry): ~2048
// values, 256 threads, 64 registers, up to four blocks an SM; fewer where
// the span would not fit.
//
// K14 and K15 are still dense products: the shared-memory SGEMM of
// tile_mm.cuh (f32 FMA, no TF32, as K10-K12), of depth K m1 (K14) or
// nperseg (K15), with an A operand that is never materialised:
//   K14: output chunk c (hop samples) of row b is the sum over taps
//        k < K of Z[b, c - k, :] A[:, k hop : (k + 1) hop]: a product of
//        depth K m1 whose A row at tap k is segment c - k, masked where that
//        segment does not exist. Every output is written once by one
//        thread: no atomics, no scatter-add, the same bits every run.
//   K15: row (b, s) of A starts at b n_sig + s hop (the frame view, its
//        overlapping re-reads served by L1/L2); the epilogue squares (or
//        takes conj(X) Y of the two signals' spectra) and sums the tile's
//        segment rows in registers, then across the block's threads through
//        shared memory, into one partial per (row, segment tile, column).
//        A block has no sequential grid to carry a sum (the TPU kernel
//        revisits one output block), so a second small pass sums the
//        partials over the segment tiles in a fixed order: deterministic.
//        The segment tiles are what fill 132 SMs when batch x column tiles
//        are few.
// Rows of a batch are gridDim.z there; a batch beyond 65535 rows runs in
// several launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "real_fft.cuh"
#include "tile_mm.cuh"

namespace k13 {

using tpufft_fft::Div;
using tpufft_fft::Radices;
using tpufft_fft::pad;
using tpufft_minor::Geometry;
using tpufft_minor::launch_geometry;
using tile_mm::to_f32;

constexpr int kBlock = 512;           // threads of a block at most
constexpr int kPer = 8;               // stage values a thread
constexpr size_t kSpanBytes = 64 << 10;   // the largest span a block copies

// 16 bytes from device to shared memory without passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__host__ __device__ __forceinline__ size_t round16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Byte offsets of a block's shared regions: the stage buffer (pad(frames
// L) float2), the signal span (raw storage values, 16 bytes of slack a
// side for the alignment of its copy), the window, the per-frame detrend
// (mean, slope) pairs.
struct Layout {
  size_t sig, win, stats, bytes;
  __host__ __device__ Layout(int frames, int L, int hop, int nperseg,
                             int elem) {
    sig = round16((size_t)pad(frames * L) * sizeof(float2));
    win = sig + round16(((size_t)(frames - 1) * hop + nperseg) * elem + 32);
    stats = win + round16((size_t)nperseg * sizeof(float));
    bytes = stats + (size_t)frames * sizeof(float2);
  }
};

// K13. Block (b, run) transforms frames s0 .. s0 + frames - 1 of signal row
// b, s0 = run * frames, into rows s0.. of the (batch, nseg, m1) planes
// yr/yi. kPacked: nfft = 2 plan.n (stages of length m = plan.n on
// z[j] = g[2j] + i g[2j+1], half_tw[k] = exp(-2 pi i k / nfft), k <= m);
// otherwise nfft = plan.n (odd). detrend: 0 none, 1 constant, 2 linear.
template <class T, bool kPacked>
__global__ void __launch_bounds__(kBlock, 2)
stft_frames_kernel(const T* __restrict__ x, const float* __restrict__ win,
                   const float* __restrict__ cr, const float* __restrict__ ci,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ half_tw, int64_t n_total,
                   int64_t n_sig, int hop, int nseg, int nperseg, int detrend,
                   Radices plan, int frames, int runs) {
  extern __shared__ float4 tpufft_stft_smem[];   // 16-byte aligned
  char* base = reinterpret_cast<char*>(tpufft_stft_smem);
  const int L = plan.n;
  const int m1 = (kPacked ? 2 * L : L) / 2 + 1;
  const Layout lay(frames, L, hop, nperseg, (int)sizeof(T));
  float2* buf = reinterpret_cast<float2*>(base);
  T* sig = reinterpret_cast<T*>(base + lay.sig);
  float* wtab = reinterpret_cast<float*>(base + lay.win);
  float2* stats = reinterpret_cast<float2*>(base + lay.stats);

  const int64_t b = blockIdx.x / runs;
  const int s0 = (int)(blockIdx.x - b * runs) * frames;
  const int here = min(frames, nseg - s0);

  // the span of the run, in 16-byte chunks from the aligned address at or
  // below its first sample; chunks that reach outside the signal go
  // element by element
  constexpr int E = 16 / sizeof(T);
  const int64_t a = b * n_sig + (int64_t)s0 * hop;
  const int lead =
      (int)((reinterpret_cast<uintptr_t>(x + a) & 15) / sizeof(T));
  const int64_t a16 = a - lead;
  const int chunks = (lead + (here - 1) * hop + nperseg + E - 1) / E;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int64_t g = a16 + (int64_t)c * E;
    if (g >= 0 && g + E <= n_total) {
      cp_async16(sig + c * E, x + g);
    } else {
      for (int e = 0; e < E; ++e)
        if (g + e >= 0 && g + e < n_total) sig[c * E + e] = x[g + e];
    }
  }
  for (int i = threadIdx.x; i < nperseg; i += blockDim.x) wtab[i] = win[i];
  cp_async_wait_all();
  __syncthreads();

  // detrend: each frame's mean and its first moment about the centre,
  // one warp a frame
  const float mid = 0.5f * (float)(nperseg - 1);
  if (detrend) {
    const int lane = threadIdx.x & 31;
    const float tt =
        (float)nperseg * ((float)nperseg * (float)nperseg - 1.f) / 12.f;
    for (int r = threadIdx.x >> 5; r < here; r += blockDim.x >> 5) {
      const T* f = sig + lead + r * hop;
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < nperseg; j += 32) {
        const float v = to_f32(f[j]);
        s1 += v;
        s2 += v * ((float)j - mid);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0)
        stats[r] = make_float2(s1 / (float)nperseg,
                               detrend == 2 && nperseg > 1 ? s2 / tt : 0.f);
    }
    __syncthreads();
  }

  // detrended, windowed, zero-padded frames into the stage buffer
  const Div by_L(L);
  const int total = frames * L;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) {
      const int r = by_L(e), j = e - r * L;
      float2 z = make_float2(0.f, 0.f);
      if (r < here) {
        const float2 st = detrend ? stats[r] : make_float2(0.f, 0.f);
        const T* f = sig + lead + r * hop;
        auto sample = [&](int i) {
          return i < nperseg
                     ? (to_f32(f[i]) - st.x - st.y * ((float)i - mid)) *
                           wtab[i]
                     : 0.f;
        };
        z = kPacked ? make_float2(sample(2 * j), sample(2 * j + 1))
                    : make_float2(sample(j), 0.f);
      }
      buf[pad(e)] = z;
    }
  }
  __syncthreads();
  tpufft_fft::run_stages<kPer>(buf, tw, plan, frames, false);

  // bins times c; the block's frames are one contiguous run of each plane
  const Div by_m1(m1);
  const int64_t out0 = (b * nseg + s0) * (int64_t)m1;
  const int outs = here * m1;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int r = by_m1(e), k = e - r * m1;
    const float2 X = kPacked ? tpufft_real::untangle(buf, r * L, L, k, half_tw)
                             : buf[pad(r * L + k)];
    const float c_r = __ldg(&cr[k]), c_i = __ldg(&ci[k]);
    yr[out0 + e] = X.x * c_r - X.y * c_i;
    yi[out0 + e] = X.x * c_i + X.y * c_r;
  }
}

template <class T, bool kPacked>
int launch(const void* x, const float* win, const float* cr, const float* ci,
           float* yr, float* yi, const float2* tw, const float2* half_tw,
           int64_t batch, int64_t n_sig, int hop, int nseg, int nperseg,
           int detrend, const Radices& plan, cudaStream_t stream) {
  auto* kernel = stft_frames_kernel<T, kPacked>;
  const int L = plan.n;
  const Geometry g = launch_geometry(L);
  if (g.per != kPer || g.threads > kBlock) return (int)cudaErrorInvalidValue;
  // half of K1's rows a block: ~2048 values, 256 threads, up to four
  // blocks an SM (tools/stft_phases.py: faster than K1's ~4096)
  int frames = g.rows > 1 ? g.rows / 2 : 1;
  if (frames > nseg) frames = nseg;
  while (frames > 1 &&
         ((size_t)(frames - 1) * hop + nperseg) * sizeof(T) > kSpanBytes)
    frames = (frames + 1) / 2;
  const Layout lay(frames, L, hop, nperseg, (int)sizeof(T));
  if (lay.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((frames * L + kPer - 1) / kPer + 31) / 32 * 32;
  const cudaError_t err = tpufft_fft::allow_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int runs = (nseg + frames - 1) / frames;
  const long long blocks = batch * runs;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, lay.bytes, stream>>>(
      static_cast<const T*>(x), win, cr, ci, yr, yi, tw, half_tw,
      batch * n_sig, n_sig, hop, nseg, nperseg, detrend, plan, frames, runs);
  return (int)cudaGetLastError();
}

}  // namespace k13

namespace {

using namespace tile_mm;

constexpr int64_t kMaxGrid = 65535;   // gridDim.y and gridDim.z limits

template <class T>
__global__ void __launch_bounds__(kThreads)
istft_kernel(const T* __restrict__ zr, const T* __restrict__ zi,
             const float* __restrict__ ar, const float* __restrict__ ai,
             float* __restrict__ out, int nseg, int hop, int taps,
             int nperseg, int m1) {
  constexpr int TM = 8;
  __shared__ __align__(16) Smem<TM, RealPart::PA, RealPart::PB> sm;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t b = blockIdx.z;
  const int c0 = blockIdx.y * Tile<TM>::BM;
  const int col0 = blockIdx.x * kBN;
  const int nchunk = nseg + taps - 1;
  const T* zrb = zr + b * nseg * m1;
  const T* zib = zi + b * nseg * m1;

  float acc[RealPart::PC][TM][4];
  zero(acc);
  for (int k = 0; k < taps; ++k) {
    accumulate<RealPart, TM>(
        sm, m1,
        [&](int q, int r, int m) {
          const int s = c0 + r - k;
          return (s >= 0 && s < nseg)
                     ? to_f32((q ? zib : zrb)[(int64_t)s * m1 + m])
                     : 0.f;
        },
        [&](int q, int m, int t) {
          return col0 + t < hop
                     ? (q ? ai : ar)[(int64_t)m * nperseg + k * hop + col0 + t]
                     : 0.f;
        },
        acc);
  }

  const int64_t n_out = (int64_t)nchunk * hop;
  const bool vec = (hop % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + row_of(i, ty);
    if (c >= nchunk) continue;
    store4(out + b * n_out + (int64_t)c * hop, col0 + tx * 4, hop, vec,
           acc[0][i]);
  }
}

template <class T, bool kCross>
__global__ void __launch_bounds__(kThreads)
welch_kernel(const T* __restrict__ x, const T* __restrict__ y,
             const float* __restrict__ mr, const float* __restrict__ mi,
             float* __restrict__ part, int64_t n_sig, int hop, int nseg,
             int nperseg, int m1) {
  using Op = std::conditional_t<kCross, PairComplex, RealComplex>;
  constexpr int TM = kCross ? 4 : 8;   // four accumulator planes: fewer rows
  constexpr int NP = kCross ? 2 : 1;   // output planes
  __shared__ __align__(16) Smem<TM, Op::PA, Op::PB> sm;
  __shared__ float red[NP][16][kBN];
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t b = blockIdx.z;
  const int s0 = blockIdx.y * Tile<TM>::BM;
  const int col0 = blockIdx.x * kBN;
  const T* xb = x + b * n_sig;
  const T* yb = kCross ? y + b * n_sig : nullptr;

  float acc[Op::PC][TM][4];
  zero(acc);
  // segments past nseg load zeros, so their spectra add nothing below
  accumulate<Op, TM>(
      sm, nperseg,
      [&](int q, int r, int k) {
        const int s = s0 + r;
        return s < nseg ? to_f32((q ? yb : xb)[(int64_t)s * hop + k]) : 0.f;
      },
      [&](int q, int k, int c) {
        return col0 + c < m1 ? (q ? mi : mr)[(int64_t)k * m1 + col0 + c]
                             : 0.f;
      },
      acc);

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pr = 0.f, pi = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (kCross) {   // conj(X) Y
        pr += acc[0][i][j] * acc[2][i][j] + acc[1][i][j] * acc[3][i][j];
        pi += acc[0][i][j] * acc[3][i][j] - acc[1][i][j] * acc[2][i][j];
      } else {
        pr += acc[0][i][j] * acc[0][i][j] + acc[1][i][j] * acc[1][i][j];
      }
    }
    red[0][ty][tx * 4 + j] = pr;
    if constexpr (kCross) red[NP - 1][ty][tx * 4 + j] = pi;
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int col = col0 + threadIdx.x;
    if (col < m1) {
      const int64_t tiles = gridDim.y;
      const int64_t off = (b * tiles + blockIdx.y) * m1 + col;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += red[q][t][threadIdx.x];
        // plane q of the partials follows plane 0's (rows x tiles x m1)
        part[q * (int64_t)gridDim.z * tiles * m1 + off] = s;
      }
    }
  }
}

// out[b, c] = sum over tiles t, in order, of part[b, t, c]
__global__ void sum_tiles_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int64_t rows,
                                 int tiles, int m1) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * m1) return;
  const int64_t b = idx / m1;
  const int c = (int)(idx % m1);
  const float* p = part + b * tiles * m1 + c;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[(int64_t)t * m1];
  out[idx] = s;
}

int tiles_of(int64_t n, int bm) { return (int)((n + bm - 1) / bm); }

template <class T>
int launch_istft(const T* zr, const T* zi, const float* ar, const float* ai,
                 float* out, int64_t batch, int nseg, int hop, int nperseg,
                 int m1, cudaStream_t stream) {
  const int taps = nperseg / hop;
  const int nchunk = nseg + taps - 1;
  const int tiles = tiles_of(nchunk, Tile<8>::BM);
  if (tiles > kMaxGrid) return (int)cudaErrorInvalidValue;
  const int64_t n_out = (int64_t)nchunk * hop;
  for (int64_t b0 = 0; b0 < batch; b0 += kMaxGrid) {
    const int64_t rows = batch - b0 < kMaxGrid ? batch - b0 : kMaxGrid;
    const dim3 grid(tiles_of(hop, kBN), tiles, (unsigned)rows);
    istft_kernel<T><<<grid, kThreads, 0, stream>>>(
        zr + b0 * nseg * m1, zi + b0 * nseg * m1, ar, ai, out + b0 * n_out,
        nseg, hop, taps, nperseg, m1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class T, bool kCross>
int launch_welch(const T* x, const T* y, const float* mr, const float* mi,
                 float* part, float* outr, float* outi, int64_t batch,
                 int64_t n_sig, int hop, int nseg, int nperseg, int m1,
                 cudaStream_t stream) {
  constexpr int BM = Tile<kCross ? 4 : 8>::BM;
  const int tiles = tiles_of(nseg, BM);
  if (tiles > kMaxGrid) return (int)cudaErrorInvalidValue;
  float* outs[2] = {outr, outi};
  for (int64_t b0 = 0; b0 < batch; b0 += kMaxGrid) {
    const int64_t rows = batch - b0 < kMaxGrid ? batch - b0 : kMaxGrid;
    const dim3 grid(tiles_of(m1, kBN), tiles, (unsigned)rows);
    welch_kernel<T, kCross><<<grid, kThreads, 0, stream>>>(
        x + b0 * n_sig, kCross ? y + b0 * n_sig : nullptr, mr, mi, part,
        n_sig, hop, nseg, nperseg, m1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t n = rows * m1;
    for (int q = 0; q < (kCross ? 2 : 1); ++q) {
      sum_tiles_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          part + q * rows * tiles * m1, outs[q] + b0 * m1, rows, tiles, m1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

// K13: x (batch, n_sig) f32 or bf16 (bf16 != 0), win (nperseg) f32, cr/ci
// (nfft/2 + 1) f32, yr/yi (batch, nseg, nfft/2 + 1) f32; frame s of row b
// starts at b n_sig + s hop, with (nseg - 1) hop + nperseg <= n_sig and
// nperseg <= nfft. detrend: 0 none, 1 constant, 2 linear. With L = nfft/2
// for even nfft and L = nfft for odd: tw holds exp(-2 pi i k / L), k < L,
// radices[0:nstages] multiply to L (each 2, 4, 8 or an odd value up to
// 127), half_tw (read for even nfft) exp(-2 pi i k / nfft), k <= nfft/2.
// Returns 0 or a CUDA error.
extern "C" int tpufft_stft_frames(const void* x, const void* win,
                                  const void* cr, const void* ci, void* yr,
                                  void* yi, const void* tw,
                                  const void* half_tw, long long batch,
                                  long long n_sig, int hop, int nseg,
                                  int nperseg, int nfft, int detrend,
                                  const int* radices, int nstages, int bf16,
                                  void* stream) {
  tpufft_fft::Radices plan;
  const bool even = nfft % 2 == 0;
  if (batch < 0 || hop < 1 || nseg < 1 || nperseg < 1 || nfft < 2 ||
      nperseg > nfft || detrend < 0 || detrend > 2 ||
      (int64_t)(nseg - 1) * hop + nperseg > n_sig ||
      !tpufft_fft::make_radices(even ? nfft / 2 : nfft, radices, nstages,
                                &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(win);
  const auto* c_r = static_cast<const float*>(cr);
  const auto* c_i = static_cast<const float*>(ci);
  auto* o_r = static_cast<float*>(yr);
  auto* o_i = static_cast<float*>(yi);
  const auto* t = static_cast<const float2*>(tw);
  const auto* h = static_cast<const float2*>(half_tw);
  if (bf16)
    return even ? k13::launch<__nv_bfloat16, true>(
                      x, w, c_r, c_i, o_r, o_i, t, h, batch, n_sig, hop, nseg,
                      nperseg, detrend, plan, st)
                : k13::launch<__nv_bfloat16, false>(
                      x, w, c_r, c_i, o_r, o_i, t, h, batch, n_sig, hop, nseg,
                      nperseg, detrend, plan, st);
  return even ? k13::launch<float, true>(x, w, c_r, c_i, o_r, o_i, t, h, batch,
                                         n_sig, hop, nseg, nperseg, detrend,
                                         plan, st)
              : k13::launch<float, false>(x, w, c_r, c_i, o_r, o_i, t, h,
                                          batch, n_sig, hop, nseg, nperseg,
                                          detrend, plan, st);
}

// K14: zr/zi (batch, nseg, m1) f32 or bf16, ar/ai (m1, nperseg) f32 with
// nperseg % hop == 0, out (batch, (nseg + nperseg / hop - 1) hop) f32.
// Returns 0 or a CUDA error.
extern "C" int tpufft_istft_ola(const void* zr, const void* zi,
                                const void* ar, const void* ai, void* out,
                                long long batch, int nseg, int hop,
                                int nperseg, int m1, int bf16, void* stream) {
  if (batch < 0 || hop < 1 || nseg < 1 || m1 < 1 || nperseg < hop ||
      nperseg % hop != 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fr = static_cast<const float*>(ar);
  const auto* fi = static_cast<const float*>(ai);
  if (bf16)
    return launch_istft(static_cast<const __nv_bfloat16*>(zr),
                        static_cast<const __nv_bfloat16*>(zi), fr, fi,
                        static_cast<float*>(out), batch, nseg, hop, nperseg,
                        m1, st);
  return launch_istft(static_cast<const float*>(zr),
                      static_cast<const float*>(zi), fr, fi,
                      static_cast<float*>(out), batch, nseg, hop, nperseg, m1,
                      st);
}

// Rows of K15's partials a launch needs: (batch, tiles, m1) floats per
// output plane, tiles = ceil(nseg / segment rows of a block).
extern "C" long long tpufft_welch_partial_floats(long long batch, int nseg,
                                                 int m1, int cross) {
  const int bm = cross ? Tile<4>::BM : Tile<8>::BM;
  const long long rows = batch < kMaxGrid ? batch : kMaxGrid;
  return (cross ? 2 : 1) * rows * tiles_of(nseg, bm) * (long long)m1;
}

// K15: x (and y when cross != 0) (batch, n_sig) f32 or bf16, mr/mi
// (nperseg, m1) f32, part scratch of tpufft_welch_partial_floats floats,
// outr (and outi when cross) (batch, m1) f32. Returns 0 or a CUDA error.
extern "C" int tpufft_welch_accum(const void* x, const void* y,
                                  const void* mr, const void* mi, void* part,
                                  void* outr, void* outi, long long batch,
                                  long long n_sig, int hop, int nseg,
                                  int nperseg, int m1, int cross, int bf16,
                                  void* stream) {
  if (batch < 0 || hop < 1 || nseg < 1 || nperseg < 1 || m1 < 1 ||
      (int64_t)(nseg - 1) * hop + nperseg > n_sig)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fr = static_cast<const float*>(mr);
  const auto* fi = static_cast<const float*>(mi);
  auto* p = static_cast<float*>(part);
  auto* o_r = static_cast<float*>(outr);
  auto* o_i = static_cast<float*>(outi);
  if (bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* yb = static_cast<const __nv_bfloat16*>(y);
    return cross ? launch_welch<__nv_bfloat16, true>(
                       xb, yb, fr, fi, p, o_r, o_i, batch, n_sig, hop, nseg,
                       nperseg, m1, st)
                 : launch_welch<__nv_bfloat16, false>(
                       xb, nullptr, fr, fi, p, o_r, nullptr, batch, n_sig,
                       hop, nseg, nperseg, m1, st);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  return cross ? launch_welch<float, true>(xf, yf, fr, fi, p, o_r, o_i, batch,
                                           n_sig, hop, nseg, nperseg, m1, st)
               : launch_welch<float, false>(xf, nullptr, fr, fi, p, o_r,
                                            nullptr, batch, n_sig, hop, nseg,
                                            nperseg, m1, st);
}
