// The short-time Fourier kernels: overlapped frames of a signal times a
// host-built matrix, with plain C entry points for ctypes
// (tpufft_torch/kernels/stft_mm.py binds and checks them).
//
// Replaces three Pallas TPU kernels of tpufft/kernels/mxu_fft.py:
//   K13 build_stft_overlap: a real signal (batch, n_sig) -> spectrum planes
//       (batch, nseg, m1); frame s of row b is x[b, s hop : s hop + nperseg]
//       times a complex (nperseg, m1) matrix M that folds the detrend, the
//       window, the zero-pad to nfft, the DFT and the scale;
//   K14 build_istft_ola: spectrum planes (batch, nseg, m1) -> the
//       overlap-added signal (batch, (nseg + K - 1) hop), K = nperseg / hop;
//       segment s contributes Zr Ar + Zi Ai (A is (m1, nperseg)) at s hop;
//       unnormalised (the window-sum division stays with the caller);
//   K15 build_welch_accum: the sum over segments of |F_s M|^2 (welch), or
//       of conj(F_s M) (G_s M) as two planes (csd), -> (batch, m1); the
//       per-segment spectra never reach device memory.
// Signals and spectra are f32 or bf16 (computed in f32), matrices and
// results f32, all row-major and contiguous.
//
// What bounds them on an H100: FP32 arithmetic. Each is a dense product
// of depth nperseg (K13, K15) or K m1 (K14) with 4 flop per depth step and
// output for about 8 bytes of traffic an output: at nperseg = 256 that is
// ~1000 flop a byte, far above the ~20 where the card's 67 TFLOP/s of FP32
// FMA meets its memory rate. So all three are the shared-memory SGEMM of
// tile_mm.cuh (f32 FMA, no TF32, as K10-K12), with an A operand that is
// never materialised:
//   K13: row (b, s) of A starts at b n_sig + s hop, so A is the frame view
//        with leading dimension hop; the nperseg / hop overlapping re-reads
//        come from L1/L2, never as a frame tensor in device memory. A real
//        X times a complex M: one X slice staged, Yr and Yi accumulated.
//   K14: output chunk c (hop samples) of row b is the sum over taps
//        k < K of Z[b, c - k, :] A[:, k hop : (k + 1) hop]: a product of
//        depth K m1 whose A row at tap k is segment c - k, masked where that
//        segment does not exist. Every output is written once by one
//        thread: no atomics, no scatter-add, the same bits every run.
//   K15: K13's product with an epilogue that squares (or takes conj(X) Y
//        of the two signals' spectra) and sums the tile's segment rows in
//        registers, then across the block's threads through shared memory,
//        into one partial per (row, segment tile, column). A block has no
//        sequential grid to carry a sum (the TPU kernel revisits one
//        output block), so a second small pass sums the partials over the
//        segment tiles in a fixed order: deterministic. The segment tiles
//        are what fill 132 SMs when batch x column tiles are few.
// Rows of a batch are gridDim.z; a batch beyond 65535 rows runs in several
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;

constexpr int64_t kMaxGrid = 65535;   // gridDim.y and gridDim.z limits

// At most 128 registers, so two blocks share an SM: left alone ptxas gives
// the kernel 159 (one block an SM), 1.2x slower on an H100 (PERF.md).
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
stft_kernel(const T* __restrict__ x, const float* __restrict__ mr,
            const float* __restrict__ mi, float* __restrict__ yr,
            float* __restrict__ yi, int64_t n_sig, int hop, int nseg,
            int nperseg, int m1) {
  constexpr int TM = 8;
  __shared__ __align__(16) Smem<TM, RealComplex::PA, RealComplex::PB> sm;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t b = blockIdx.z;
  const int s0 = blockIdx.y * Tile<TM>::BM;
  const int col0 = blockIdx.x * kBN;
  const T* xb = x + b * n_sig;

  float acc[RealComplex::PC][TM][4];
  zero(acc);
  accumulate<RealComplex, TM>(
      sm, nperseg,
      [&](int, int r, int k) {
        const int s = s0 + r;
        return s < nseg ? to_f32(xb[(int64_t)s * hop + k]) : 0.f;
      },
      [&](int q, int k, int c) {
        return col0 + c < m1 ? (q ? mi : mr)[(int64_t)k * m1 + col0 + c]
                             : 0.f;
      },
      acc);

  const bool vec = (m1 % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = s0 + row_of(i, ty);
    if (s >= nseg) continue;
    const int64_t off = (b * nseg + s) * m1;
    store4(yr + off, col0 + tx * 4, m1, vec, acc[0][i]);
    store4(yi + off, col0 + tx * 4, m1, vec, acc[1][i]);
  }
}

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
int launch_stft(const T* x, const float* mr, const float* mi, float* yr,
                float* yi, int64_t batch, int64_t n_sig, int hop, int nseg,
                int nperseg, int m1, cudaStream_t stream) {
  const int tiles = tiles_of(nseg, Tile<8>::BM);
  if (tiles > kMaxGrid) return (int)cudaErrorInvalidValue;
  for (int64_t b0 = 0; b0 < batch; b0 += kMaxGrid) {
    const int64_t rows = batch - b0 < kMaxGrid ? batch - b0 : kMaxGrid;
    const dim3 grid(tiles_of(m1, kBN), tiles, (unsigned)rows);
    stft_kernel<T><<<grid, kThreads, 0, stream>>>(
        x + b0 * n_sig, mr, mi, yr + b0 * nseg * m1, yi + b0 * nseg * m1,
        n_sig, hop, nseg, nperseg, m1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

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

// K13: x (batch, n_sig) f32 or bf16 (bf16 != 0), mr/mi (nperseg, m1) f32,
// yr/yi (batch, nseg, m1) f32; frame s of row b starts at b n_sig + s hop,
// with (nseg - 1) hop + nperseg <= n_sig. Returns 0 or a CUDA error.
extern "C" int tpufft_stft_frames(const void* x, const void* mr,
                                  const void* mi, void* yr, void* yi,
                                  long long batch, long long n_sig, int hop,
                                  int nseg, int nperseg, int m1, int bf16,
                                  void* stream) {
  if (batch < 0 || hop < 1 || nseg < 1 || nperseg < 1 || m1 < 1 ||
      (int64_t)(nseg - 1) * hop + nperseg > n_sig)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fr = static_cast<const float*>(mr);
  const auto* fi = static_cast<const float*>(mi);
  if (bf16)
    return launch_stft(static_cast<const __nv_bfloat16*>(x), fr, fi,
                       static_cast<float*>(yr), static_cast<float*>(yi), batch,
                       n_sig, hop, nseg, nperseg, m1, st);
  return launch_stft(static_cast<const float*>(x), fr, fi,
                     static_cast<float*>(yr), static_cast<float*>(yi), batch,
                     n_sig, hop, nseg, nperseg, m1, st);
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
