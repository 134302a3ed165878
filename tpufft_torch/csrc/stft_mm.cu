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
//       unnormalised (the window-sum division stays with the caller). The
//       TPU kernel and the callers' backward take A = the inverse onesided
//       DFT of c Z (a per-bin complex factor c: the unscale, a phase roll)
//       truncated to nperseg times a real window; the port's line form
//       takes the window, c and nfft;
//   K15 build_welch_accum: the sum over frames of |X_s|^2 (welch), or of
//       conj(X_s) Y_s as two planes (csd), -> (batch, m1), X_s the spectrum
//       of K13 with c = 1; the per-frame spectra never reach device memory.
// Signals and spectra are f32 or bf16 (computed in f32), tables and
// results f32, all row-major and contiguous.
//
// K13 and K15 on an H100 are bound by device-memory bytes: K13 reads the
// signal once and writes the planes (at nperseg 256, hop 128: 4 bytes in,
// 8.1 bytes out per sample), K15 only reads the signal (4 bytes a sample;
// two signals for csd), against ~2.5 nfft log2 nfft flops a frame. A dense
// product with M costs 4 nperseg flops a bin, ~32x the FFT's at nfft =
// 256, which bounded the earlier forms of both by the FP32 peak, above
// torch.stft's time. So both run one frame core, an FFT: a block takes one
// row and a run of `frames` consecutive frames, copies the run's span,
// (frames - 1) hop + nperseg samples, into shared memory once (16-byte
// cp.async where the chunk lies inside the signal), reads the overlapping
// frames from there, takes each frame's mean and first moment by a warp
// reduction, windows and zero-pads it into the stage buffer as K7 packs a
// row (even nfft: m = nfft/2 complex values x[2j] + i x[2j+1]; odd nfft:
// the row with a zero imaginary part) and runs K7's stages
// (fft_stages.cuh). A block takes half the rows K1 packs of its stage
// length (minor_fft.cuh:launch_geometry): ~2048 values, 256 threads, 64
// registers, up to four blocks an SM; fewer where the span would not fit.
// The two kernels differ in their epilogue:
//   K13 untangles the bins (real_fft.cuh), multiplies by c and stores the
//       block's frames as one contiguous, coalesced run of each plane;
//   K15 sums |X_k|^2 over the run's frames, each sum owned by one thread:
//       a thread untangles a pair of bins (k, m - k) from one read of Z[k]
//       and Z[m - k], for every groups-th frame, into its group's sums in
//       shared memory (groups = threads / pairs, 3 at nfft = 256), and the
//       groups' sums are added in order at the end. A block walks a
//       contiguous range of its row's runs and writes one partial per
//       (row, block, bin); the blocks a row are the fewest that fill the
//       card's resident blocks in whole waves. Blocks run in no order, so
//       a second small pass sums the partials of a row in a fixed order:
//       no atomics, the same bits every run. csd puts the two signals'
//       frames in one stage buffer, x's in rows 0 .. frames - 1 and y's in
//       the rows after (half the frames a block, the same stage values),
//       each packed and transformed as welch's, with its own detrend
//       statistics, and sums conj(X_k) Y_k: two real FFTs, not one complex
//       FFT of x + i y, whose split would leave each spectrum with the
//       other's rounding error (large where |X| >> |Y|).
//
// K14 on an H100 is bound by bytes too: it reads the planes once (at
// nfft 256, hop 128: 8.1 bytes a sample) and writes the signal once (4),
// against an inverse real FFT a segment and one add a sample a segment.
// A dense product with the host matrix (depth K m1, K = nperseg / hop)
// is bound by the FP32 FMA peak instead, at 0.13 of the byte bound at
// nfft 256 on the H100 (PERF.md). So K14 has two forms
// (tpufft_istft_line_form; kernels/stft_mm.py:istft_form mirrors it):
//   the line form, for nfft = 256, 512, 1024 (m = nfft / 2 = 128 to 512):
//       the inverse-real line core of real_fft.cuh (K8's) on K1's geometry
//       at m, four one-warp teams a block, a team transforming S::rows
//       segments: a wave of W = 4 S::rows segments. A block takes one row
//       and a run of output chunks (hop samples each) and computes every
//       segment that touches them; the first K - 1 are also computed by
//       the block before it (the halo), and the run is the fewest waves
//       that keep the halo at most 1/33 of a block's segments (63 chunks
//       from 64 segments at K = 2, nfft 256). Per segment the tangle reads
//       the row of Zr/Zi with 4-byte loads and multiplies by c, the core
//       runs the inverse four-step, and pass 2's pairs z'[j] times the
//       window pair (w[2j], w[2j+1]) / nfft go back into the team's tile.
//       After a block barrier each output position of the wave is owned by
//       one thread, which adds the carry of earlier waves and the wave's
//       segments covering it in segment order (a 16-byte shared read a
//       segment and a 16-byte store where hop % 4 == 0), stores it where
//       its chunk is complete and the block's, and else carries it to the
//       next wave. Shared memory is the tiles, the tables and two carry
//       buffers of nperseg floats, whatever K; hop 1 is correct, and slow.
//   the dense body, for every other nfft: the shared-memory SGEMM of
//       tile_mm.cuh (f32 FMA, no TF32, as K10's FMA body), of depth K m1,
//       with an A operand that is never materialised: output chunk c of
//       row b is the sum over taps k < K of Z[b, c - k, :] A[:, k hop :
//       (k + 1) hop], masked where that segment does not exist; A is
//       stft_mm.synthesis_matrix of the same window and c, built by the
//       wrapper. Rows of a batch are gridDim.z there; a batch beyond 65535
//       rows runs in several launches.
// In both, every output is written once by one thread: no atomics, no
// scatter-add, the same bits every run.

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

// Byte offsets of a block's shared regions: the stage buffer (pad(signals
// frames L) float2), the span of each signal (raw storage values, 16 bytes
// of slack a side for the alignment of its copy), the window, each
// signal's per-frame detrend (mean, slope) pairs.
struct Layout {
  size_t sig, span, win, stats, bytes;
  __host__ __device__ Layout(int frames, int L, int hop, int nperseg,
                             int elem, int signals = 1) {
    sig = round16((size_t)pad(signals * frames * L) * sizeof(float2));
    span = round16(((size_t)(frames - 1) * hop + nperseg) * elem + 32);
    win = sig + signals * span;
    stats = win + round16((size_t)nperseg * sizeof(float));
    bytes = stats + (size_t)signals * frames * sizeof(float2);
  }
};

// The frame core of K13 and K15: frames s0 .. s0 + here - 1 of signal row b
// of x (and of y where kCross), detrended (0 none, 1 constant, 2 linear),
// windowed and zero-padded into the stage buffer at the block's shared
// memory `base`: x's frame r in row r, y's in row frames + r, of plan.n
// values each (rows of frames r >= here zero); then every stage of `plan`:
// the buffer ends in natural order, synchronized. kPacked: nfft = 2 plan.n
// and z[j] = g[2j] + i g[2j+1]; otherwise nfft = plan.n (odd) and z[j] =
// g[j].
template <class T, bool kPacked, bool kCross>
__device__ __forceinline__ void frame_core(
    char* base, const Layout& lay, const T* __restrict__ x,
    const T* __restrict__ y, const float* __restrict__ win,
    const float2* __restrict__ tw, int64_t n_total, int64_t n_sig, int hop,
    int nperseg, int detrend, const Radices& plan, int frames, int64_t b,
    int s0, int here) {
  constexpr int kSignals = kCross ? 2 : 1;
  const int L = plan.n;
  float2* buf = reinterpret_cast<float2*>(base);
  float* wtab = reinterpret_cast<float*>(base + lay.win);
  float2* stats = reinterpret_cast<float2*>(base + lay.stats);

  // the span of the run, in 16-byte chunks from the aligned address at or
  // below its first sample; chunks that reach outside the signal go
  // element by element
  constexpr int E = 16 / sizeof(T);
  const int64_t a = b * n_sig + (int64_t)s0 * hop;
  int lead[kSignals];
#pragma unroll
  for (int q = 0; q < kSignals; ++q) {
    const T* src = q ? y : x;
    T* sig = reinterpret_cast<T*>(base + lay.sig + q * lay.span);
    lead[q] = (int)((reinterpret_cast<uintptr_t>(src + a) & 15) / sizeof(T));
    const int64_t a16 = a - lead[q];
    const int chunks = (lead[q] + (here - 1) * hop + nperseg + E - 1) / E;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int64_t g = a16 + (int64_t)c * E;
      if (g >= 0 && g + E <= n_total) {
        cp_async16(sig + c * E, src + g);
      } else {
        for (int e = 0; e < E; ++e)
          if (g + e >= 0 && g + e < n_total) sig[c * E + e] = src[g + e];
      }
    }
  }
  for (int i = threadIdx.x; i < nperseg; i += blockDim.x) wtab[i] = win[i];
  cp_async_wait_all();
  __syncthreads();
  // frame r of signal q in the shared span
  const auto frame = [&](int q, int r) {
    return reinterpret_cast<const T*>(base + lay.sig + q * lay.span) +
           (q ? lead[kSignals - 1] : lead[0]) + r * hop;
  };

  // detrend: each frame's mean and its first moment about the centre,
  // one warp a (signal, frame)
  const float mid = 0.5f * (float)(nperseg - 1);
  if (detrend) {
    const int lane = threadIdx.x & 31;
    const float tt =
        (float)nperseg * ((float)nperseg * (float)nperseg - 1.f) / 12.f;
    for (int rq = threadIdx.x >> 5; rq < kSignals * here;
         rq += blockDim.x >> 5) {
      const int q = kCross && rq >= here ? 1 : 0;
      const int r = rq - q * here;
      const T* f = frame(q, r);
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
        stats[q * frames + r] =
            make_float2(s1 / (float)nperseg,
                        detrend == 2 && nperseg > 1 ? s2 / tt : 0.f);
    }
    __syncthreads();
  }

  // detrended, windowed, zero-padded frames into the stage buffer
  const Div by_L(L);
  const int total = kSignals * frames * L;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < total) {
      const int row = by_L(e), j = e - row * L;
      const int q = kCross && row >= frames ? 1 : 0;
      const int r = row - q * frames;
      float2 z = make_float2(0.f, 0.f);
      if (r < here) {
        const float2 st =
            detrend ? stats[q * frames + r] : make_float2(0.f, 0.f);
        const T* f = frame(q, r);
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
  tpufft_fft::run_stages<kPer>(buf, tw, plan, kSignals * frames, false);
}

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
  const float2* buf = reinterpret_cast<const float2*>(base);

  const int64_t b = blockIdx.x / runs;
  const int s0 = (int)(blockIdx.x - b * runs) * frames;
  const int here = min(frames, nseg - s0);
  frame_core<T, kPacked, false>(base, lay, x, nullptr, win, tw, n_total,
                                n_sig, hop, nperseg, detrend, plan, frames,
                                b, s0, here);

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

// K15's units of epilogue work: for even nfft (kPacked) the pairs of bins
// (u, L - u), u <= L/2, whose untangle reads the same two values; for odd
// nfft the m1 bins. Groups of `units` threads take every groups-th frame of
// a run, each group with its own sums: groups = blockDim / units, at least
// one.
__host__ __device__ __forceinline__ int welch_units(int L, bool packed) {
  return packed ? L / 2 + 1 : (L + 1) / 2;
}
__host__ __device__ __forceinline__ int welch_groups(int threads, int units) {
  return threads / units > 1 ? threads / units : 1;
}

// The untangle of bins k and m - k (k <= m/2) of a packed row's length-m
// DFT Z at pad(row0 + j), as tpufft_real::untangle computes each, from one
// read of Z[k] and Z[m - k].
__device__ __forceinline__ void untangle_pair(
    const float2* buf, int row0, int m, int k,
    const float2* __restrict__ half_tw, float2& xk, float2& xmk) {
  const float2 a = buf[pad(row0 + k)];                      // Z[k]
  const float2 b = buf[pad(row0 + (k == 0 ? 0 : m - k))];   // Z[m-k]
  const auto bin = [](float2 p, float2 q, float2 w) {
    const float2 s = make_float2(p.x + q.x, p.y - q.y);     // P + conj Q
    const float2 wd = tpufft_fft::cmul(w, make_float2(p.x - q.x, p.y + q.y));
    return make_float2(0.5f * (s.x + wd.y), 0.5f * (s.y - wd.x));
  };
  xk = bin(a, b, __ldg(&half_tw[k]));
  xmk = bin(b, a, __ldg(&half_tw[m - k]));
}

// K15. Block (b, chunk) of per_row blocks a row sums over runs r0 .. r1 - 1
// of signal row b (r0 = chunk runs / per_row): the frame core, then the
// bins of the run's frames. Thread t < groups units takes unit u = t mod
// units (welch_units) of frames r = g, g + groups, ... (g = t / units) and
// adds their sum, taken in order, to the group's sums in shared memory,
// which only it touches: sum[(g planes + q) m1 + k]. At the end the block
// adds the groups' sums in order and writes them to part[blockIdx.x m1 +
// k] (the imaginary plane of csd gridDim.x m1 further on). welch: |X_k|^2;
// csd (kCross): conj(X_k) Y_k, X's frame r in stage row r and Y's in row
// frames + r. X_k is the untangle for even nfft (kPacked) and Z_k for odd.
template <class T, bool kPacked, bool kCross>
__global__ void __launch_bounds__(kBlock, 2)
welch_frames_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ win, float* __restrict__ part,
                    const float2* __restrict__ tw,
                    const float2* __restrict__ half_tw, int64_t n_total,
                    int64_t n_sig, int hop, int nseg, int nperseg,
                    int detrend, Radices plan, int frames, int runs,
                    int per_row) {
  extern __shared__ float4 tpufft_welch_smem[];   // 16-byte aligned
  char* base = reinterpret_cast<char*>(tpufft_welch_smem);
  constexpr int kPlanes = kCross ? 2 : 1;
  const int L = plan.n;
  const int m1 = (kPacked ? 2 * L : L) / 2 + 1;
  const Layout lay(frames, L, hop, nperseg, (int)sizeof(T), kPlanes);
  const float2* buf = reinterpret_cast<const float2*>(base);
  float* sum = reinterpret_cast<float*>(base + round16(lay.bytes));
  const int units = welch_units(L, kPacked);
  const int groups = welch_groups(blockDim.x, units);

  const int64_t b = blockIdx.x / per_row;
  const int chunk = (int)(blockIdx.x - b * per_row);
  const int r0 = (int)((int64_t)chunk * runs / per_row);
  const int r1 = (int)((int64_t)(chunk + 1) * runs / per_row);
  for (int k = threadIdx.x; k < groups * kPlanes * m1; k += blockDim.x)
    sum[k] = 0.f;
  for (int run = r0; run < r1; ++run) {
    const int s0 = run * frames;
    const int here = min(frames, nseg - s0);
    frame_core<T, kPacked, kCross>(base, lay, x, y, win, tw, n_total, n_sig,
                                   hop, nperseg, detrend, plan, frames, b,
                                   s0, here);
    // X times conj-or-not Y: |X|^2 (welch) or conj(X) Y (csd), added to
    // (re, im)
    const auto add = [](float2 X, float2 Y, float2& acc) {
      acc.x += X.x * Y.x + X.y * Y.y;
      if (kCross) acc.y += X.x * Y.y - X.y * Y.x;
    };
    for (int t = threadIdx.x; t < groups * units; t += blockDim.x) {
      const int g = t / units, u = t - g * units;
      float* own = sum + g * kPlanes * m1;
      float2 s1 = make_float2(0.f, 0.f), s2 = s1;   // bins u and L - u
      for (int r = g; r < here; r += groups) {
        if constexpr (kPacked) {
          float2 X1, X2;
          untangle_pair(buf, r * L, L, u, half_tw, X1, X2);
          if constexpr (kCross) {
            float2 Y1, Y2;
            untangle_pair(buf, (frames + r) * L, L, u, half_tw, Y1, Y2);
            add(X1, Y1, s1);
            add(X2, Y2, s2);
          } else {
            add(X1, X1, s1);
            add(X2, X2, s2);
          }
        } else {
          const float2 X = buf[pad(r * L + u)];
          add(X, kCross ? buf[pad((frames + r) * L + u)] : X, s1);
        }
      }
      own[u] += s1.x;
      if (kCross) own[m1 + u] += s1.y;
      if (kPacked && L - u != u) {
        own[L - u] += s2.x;
        if (kCross) own[m1 + L - u] += s2.y;
      }
    }
    __syncthreads();   // the next run fills the stage buffer again
  }
  for (int k = threadIdx.x; k < kPlanes * m1; k += blockDim.x) {
    float total = 0.f;
    for (int g = 0; g < groups; ++g) total += sum[g * kPlanes * m1 + k];
    const int q = k >= m1 ? 1 : 0;
    part[((int64_t)q * gridDim.x + blockIdx.x) * m1 + (k - q * m1)] = total;
  }
}

// out[b, c] (plane q: out_q) = sum over the row's blocks t, in order, of
// part[q][b, t, c]
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ outr,
                                    float* __restrict__ outi, int64_t rows,
                                    int per_row, int m1) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * m1) return;
  const int64_t b = idx / m1;
  const int c = (int)(idx % m1);
  float* outs[2] = {outr, outi};
  for (int q = 0; q < (outi ? 2 : 1); ++q) {
    const float* p = part + (q * rows + b) * per_row * m1 + c;
    float s = 0.f;
    for (int t = 0; t < per_row; ++t) s += p[(int64_t)t * m1];
    outs[q][idx] = s;
  }
}

// K15's launch: the frames a block as K13's (half of them for two
// signals, so that a block holds as many stage values), the shared memory
// (K13's regions for one or two signals, then the groups' sums), and the
// blocks a row: the fewest that fill the resident blocks in whole waves to
// 90 %, at most one a run.
struct WelchPlan {
  int frames, threads, runs, per_row;
  size_t smem;
};

template <class T, bool kPacked, bool kCross>
int welch_plan(int64_t batch, int L, int hop, int nseg, int nperseg,
               WelchPlan* p) {
  auto* kernel = welch_frames_kernel<T, kPacked, kCross>;
  const Geometry g = launch_geometry(L);
  if (g.per != kPer || g.threads > kBlock) return (int)cudaErrorInvalidValue;
  const int planes = kCross ? 2 : 1;
  int frames = g.rows > planes ? g.rows / (2 * planes) : 1;
  if (frames > nseg) frames = nseg;
  while (frames > 1 &&
         ((size_t)(frames - 1) * hop + nperseg) * sizeof(T) > kSpanBytes)
    frames = (frames + 1) / 2;
  const int m1 = (kPacked ? 2 * L : L) / 2 + 1;
  const Layout lay(frames, L, hop, nperseg, (int)sizeof(T), planes);
  p->frames = frames;
  p->threads = ((planes * frames * L + kPer - 1) / kPer + 31) / 32 * 32;
  const int groups = welch_groups(p->threads, welch_units(L, kPacked));
  p->smem = round16(lay.bytes) + (size_t)groups * planes * m1 * sizeof(float);
  if (p->smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  p->runs = (nseg + frames - 1) / frames;
  cudaError_t err = tpufft_fft::allow_smem(kernel, p->smem);
  unsigned resident = 0;
  if (err == cudaSuccess)
    err = tpufft_minor::resident_grid(kernel, p->threads, p->smem, LLONG_MAX,
                                      &resident);
  if (err != cudaSuccess) return (int)err;
  int per_row = 1;
  for (; per_row < p->runs; ++per_row) {
    const long long blocks = batch * per_row;
    const long long waves = (blocks + resident - 1) / resident;
    if (blocks * 10 >= waves * resident * 9) break;
  }
  p->per_row = per_row;
  if (batch * per_row > INT_MAX) return (int)cudaErrorInvalidValue;
  return 0;
}

template <class T, bool kPacked, bool kCross>
int launch_welch(const void* x, const void* y, const float* win, float* part,
                 float* outr, float* outi, const float2* tw,
                 const float2* half_tw, int64_t batch, int64_t n_sig, int hop,
                 int nseg, int nperseg, int detrend, const Radices& plan,
                 cudaStream_t stream) {
  WelchPlan p;
  const int err = welch_plan<T, kPacked, kCross>(batch, plan.n, hop, nseg,
                                                 nperseg, &p);
  if (err != 0) return err;
  const int64_t blocks = batch * p.per_row;
  welch_frames_kernel<T, kPacked, kCross>
      <<<(unsigned)blocks, p.threads, p.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(y), win, part, tw,
          half_tw, batch * n_sig, n_sig, hop, nseg, nperseg, detrend, plan,
          p.frames, p.runs, p.per_row);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int m1 = (kPacked ? 2 * plan.n : plan.n) / 2 + 1;
  const int64_t n = batch * m1;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, outr, kCross ? outi : nullptr, batch, p.per_row, m1);
  return (int)cudaGetLastError();
}

// Calls f(T*, kPacked, kCross), the flags as std::bool_constant: the
// storage type, the packed core for even nfft, two signals for csd.
template <class F>
int welch_form(int bf16, int nfft, int cross, F&& f) {
  const auto flags = [&](auto t) {
    using Yes = std::true_type;
    using No = std::false_type;
    if (nfft % 2 == 0) return cross ? f(t, Yes{}, Yes{}) : f(t, Yes{}, No{});
    return cross ? f(t, No{}, Yes{}) : f(t, No{}, No{});
  };
  return bf16 ? flags(static_cast<__nv_bfloat16*>(nullptr))
              : flags(static_cast<float*>(nullptr));
}

}  // namespace k13

// K14's line form (nfft = 2m, m = 128 to 512; the header's K14 notes): the
// inverse-real line core (real_fft.cuh) on K1's geometry at m, a team of
// one warp holding S::rows segments, four teams a block: a wave is W =
// 4 S::rows segments.
namespace k14 {

using tpufft_fft::Div;
using tpufft_fft::pad;
using tpufft_minor::LaneStep;

constexpr int kThreads = 128;
// the halo's share of a block's segments, at most 1 / kHaloShare
constexpr int kHaloShare = 33;

template <int N1, int N2>
using Step = LaneStep<N1, N2, 1, kThreads>;

// A block's shared memory past the table and the wave's tiles: the window
// pairs (m float2), the factor c (m + 1 float2, padded to m + 2), and two
// carry buffers of nperseg floats.
template <int N1, int N2>
__host__ __device__ constexpr size_t fixed_floats() {
  using S = Step<N1, N2>;
  return 2 * ((size_t)S::table + (size_t)S::teams * S::rows * S::n +
              2 * (size_t)S::n + 2);
}

// The runs of the block split: a block writes `run` output chunks (hop
// samples each) from waves * W segments, K - 1 of them its halo (also
// computed by the block before it), waves the fewest with K - 1 <= waves W
// / kHaloShare.
struct Split {
  int run, runs;
};

__host__ __device__ inline Split split(int nseg, int taps, int wave) {
  const int need = kHaloShare * (taps - 1);
  const int waves = need > wave ? (need + wave - 1) / wave : 1;
  Split p;
  p.run = waves * wave - (taps - 1);
  p.runs = (nseg + taps - 1 + p.run - 1) / p.run;
  return p;
}

// Block (b, j) of `runs` a row writes output chunks [c0, c1) of row b, c0 =
// j run, c1 = min(c0 + run, nseg + K - 1), K = nperseg / hop: the samples
// [c0 hop, c1 hop) of out[b]. It takes segments s_lo = max(0, c0 - K + 1)
// .. s_hi = min(c1 - 1, nseg - 1) in waves of W from s_lo; each team
// transforms its S::rows segments of the wave: the bins times c in the
// tangle, the core, then each pair z'[j] times the window pair win2[j] =
// (w[2j], w[2j+1]) / nfft into the team's tile at r m + (j ^ ((N1 r) mod
// 16)) (as K7 writes Z back: pass 2's writes hit 16 bank pairs a half warp).
// After a block barrier the overlap-add: the wave covers the positions u <
// (nw + K - 1) hop from s_a hop (nw segments in the wave), chunk c = u /
// hop; thread i owns u = i, i + 128, ... (quads of u when hop % 4 == 0: one
// 16-byte shared read a segment, one 16-byte store) and sums, in segment
// order, the carry of earlier waves (c < K - 1) and segments q = max(0, c -
// K + 1) .. min(c, nw - 1) of the wave at sample u - q hop. Chunks c < nw
// are complete, and so is every chunk of the last wave (when s_hi < nseg - 1
// the chunks past c1 are another block's): they are stored where they lie
// in [c0, c1); the rest go to the other carry buffer at u - nw hop, read by
// the next wave. A block barrier ends the wave. Each output sample is
// written once, by one thread, as the same ordered sum in every block that
// could compute it: no atomics, the same bits every run.
template <typename T, int N1, int N2>
__global__ void __launch_bounds__(kThreads,
                                  tpufft_minor::kLaneMinBlocks(kThreads))
istft_lane_kernel(const T* __restrict__ zr, const T* __restrict__ zi,
                  const float* __restrict__ win, const float* __restrict__ cr,
                  const float* __restrict__ ci, const float2* __restrict__ tw,
                  const float2* __restrict__ half_tw, float* __restrict__ out,
                  int nseg, int hop, int nperseg, int run, int runs) {
  using S = Step<N1, N2>;
  constexpr int m = S::n, R = S::rows, W = S::teams * R;
  extern __shared__ float4 tpufft_istft_lane_smem[];   // 16-byte aligned
  float2* table = reinterpret_cast<float2*>(tpufft_istft_lane_smem);
  float2* tiles = table + S::table;     // segment q of a wave at q m
  float2* win2 = tiles + W * m;
  float2* cz = win2 + m;
  float* carry = reinterpret_cast<float*>(cz + m + 2);
  const int team = threadIdx.x / S::lanes;
  const int t = threadIdx.x - team * S::lanes;
  float2* tile = tiles + team * R * m;

  const int taps = nperseg / hop;
  const int64_t b = blockIdx.x / runs;
  const int c0 = (int)(blockIdx.x - b * runs) * run;
  const int c1 = min(c0 + run, nseg + taps - 1);
  const int s_lo = max(0, c0 - taps + 1), s_hi = min(c1 - 1, nseg - 1);
  const int64_t m1 = m + 1;
  const T* zrb = zr + b * nseg * m1;
  const T* zib = zi + b * nseg * m1;
  const int64_t n_out = (int64_t)(nseg - 1) * hop + nperseg;
  float* outb = out + b * n_out;

  const float inv_n = 1.f / (float)(2 * m);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    table[pad(i)] = __ldg(&tw[i]);
    win2[i] = make_float2(2 * i < nperseg ? __ldg(&win[2 * i]) * inv_n : 0.f,
                          2 * i + 1 < nperseg
                              ? __ldg(&win[2 * i + 1]) * inv_n
                              : 0.f);
  }
  for (int i = threadIdx.x; i <= m; i += kThreads)
    cz[i] = make_float2(__ldg(&cr[i]), __ldg(&ci[i]));
  for (int i = threadIdx.x; i < nperseg; i += kThreads) carry[i] = 0.f;
  __syncthreads();

  const Div by_hop(hop);
  const bool quads = hop % 4 == 0;
  float* old_c = carry;
  float* new_c = carry + nperseg;
  const float* seg = reinterpret_cast<const float*>(tiles);
  // float offset of sample tt of wave segment q (row q mod R of its team)
  const auto at = [&](int q, int tt) {
    return 2 * (q * m + ((tt >> 1) ^ ((N1 * (q % R)) & 15))) + (tt & 1);
  };
  for (int sa = s_lo; sa <= s_hi; sa += W) {
    const int nw = min(W, s_hi - sa + 1);
    const bool last = sa + W > s_hi;
    tpufft_real::tangle<S>(tile, t, half_tw, [&](int r, int k) {
      const int q = team * R + r;
      if (q >= nw) return make_float2(0.f, 0.f);
      const int64_t i = (int64_t)(sa + q) * m1 + k;
      return tpufft_fft::cmul(
          make_float2(tpufft_fft::load_f(zrb, i), tpufft_fft::load_f(zib, i)),
          cz[k]);
    });
    typename tpufft_real::LineCore<S>::Out v;
    tpufft_real::inverse_passes<S>(tile, table, team, t, v);
    // the team's lines are read before the windowed pairs land
    tpufft_minor::team_sync<1>(team);
    tpufft_real::for_each_pair<S>(t, v, [&](int r, int j, float2 z) {
      const float2 w = win2[j];
      tile[r * m + (j ^ ((N1 * r) & 15))] = make_float2(z.x * w.x, z.y * w.y);
    });
    __syncthreads();
    const int span = (nw + taps - 1) * hop;
    const int64_t base = (int64_t)sa * hop;
    if (quads) {
      for (int u = 4 * threadIdx.x; u < span; u += 4 * kThreads) {
        const int c = by_hop(u);
        float4 acc = c < taps - 1 ? *reinterpret_cast<const float4*>(old_c + u)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = max(0, c - taps + 1); q <= min(c, nw - 1); ++q) {
          const float4 x =
              *reinterpret_cast<const float4*>(seg + at(q, u - q * hop));
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        if (c < nw || last) {
          if (sa + c >= c0 && sa + c < c1)
            *reinterpret_cast<float4*>(outb + base + u) = acc;
        } else {
          *reinterpret_cast<float4*>(new_c + u - nw * hop) = acc;
        }
      }
    } else {
      for (int u = threadIdx.x; u < span; u += kThreads) {
        const int c = by_hop(u);
        float acc = c < taps - 1 ? old_c[u] : 0.f;
        for (int q = max(0, c - taps + 1); q <= min(c, nw - 1); ++q)
          acc += seg[at(q, u - q * hop)];
        if (c < nw || last) {
          if (sa + c >= c0 && sa + c < c1) outb[base + u] = acc;
        } else {
          new_c[u - nw * hop] = acc;
        }
      }
    }
    float* swap = old_c;
    old_c = new_c;
    new_c = swap;
    __syncthreads();   // the tiles and the carry are read before the next wave
  }
}

template <typename T, int N1, int N2>
int launch_lines(const T* zr, const T* zi, const float* win, const float* cr,
                 const float* ci, const float2* tw, const float2* half_tw,
                 float* out, int64_t batch, int nseg, int hop, int nperseg,
                 cudaStream_t stream) {
  using S = Step<N1, N2>;
  auto* kernel = istft_lane_kernel<T, N1, N2>;
  const Split p = split(nseg, nperseg / hop, S::teams * S::rows);
  const size_t smem = (fixed_floats<N1, N2>() + 2 * (size_t)nperseg) * 4;
  if ((int64_t)batch * p.runs > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = tpufft_fft::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(batch * p.runs), kThreads, smem, stream>>>(
      zr, zi, win, cr, ci, tw, half_tw, out, nseg, hop, nperseg, p.run,
      p.runs);
  return (int)cudaGetLastError();
}

// Does an nfft run the line form (m = nfft / 2 a power of two from 128 to
// 512)?
inline bool line_form(int nfft) {
  const int m = nfft / 2;
  return nfft % 2 == 0 && m >= 128 && m <= 512 && (m & (m - 1)) == 0;
}

template <typename T>
int launch_line_form(const T* zr, const T* zi, const float* win,
                     const float* cr, const float* ci, const float2* tw,
                     const float2* half_tw, float* out, int64_t batch,
                     int nseg, int hop, int nperseg, int nfft,
                     cudaStream_t stream) {
  return tpufft_real::with_line_step(nfft, [&](auto step) {
    using S = decltype(step);
    if constexpr (S::n <= 512)   // line_form's nfft
      return launch_lines<T, S::N1, S::N2>(zr, zi, win, cr, ci, tw, half_tw,
                                           out, batch, nseg, hop, nperseg,
                                           stream);
    else
      return (int)cudaErrorInvalidValue;
  });
}

}  // namespace k14

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

// Is nfft one of K14's line form (1) or the dense body's (0)?
extern "C" int tpufft_istft_line_form(int nfft) {
  return k14::line_form(nfft) ? 1 : 0;
}

// K14 from the synthesis window and a per-bin factor: zr/zi (batch, nseg,
// nfft/2 + 1) f32 or bf16 (bf16 != 0), out (batch, (nseg - 1) hop +
// nperseg) f32, 16-byte aligned, nperseg % hop == 0, nperseg <= nfft <=
// 1024. Segment s of row b contributes, at s hop, its samples t < nperseg
// of win[t] irfft_nfft(c Z[b, s])[t] (numpy's irfft, 1/nfft: the
// imaginary parts of c Z at DC and, even nfft, Nyquist ignored), c = cr +
// i ci. tpufft_istft_line_form(nfft) picks the form: the line form reads
// win (nperseg), cr/ci (nfft/2 + 1), tw (exp(+2 pi i k / m), k < m = nfft
// / 2) and half_tw (exp(-2 pi i k / nfft), k <= m); the dense body reads
// ar/ai (nfft/2 + 1, nperseg) f32, the same function as a matrix
// (stft_mm.synthesis_matrix), and fails where they are null. Returns 0 or
// a CUDA error.
extern "C" int tpufft_istft_frames(const void* zr, const void* zi,
                                   const void* win, const void* cr,
                                   const void* ci, const void* tw,
                                   const void* half_tw, const void* ar,
                                   const void* ai, void* out, long long batch,
                                   int nseg, int hop, int nperseg, int nfft,
                                   int bf16, void* stream) {
  if (batch < 0 || hop < 1 || nseg < 1 || nperseg < hop ||
      nperseg % hop != 0 || nfft < 2 || nfft > 1024 || nperseg > nfft ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (!k14::line_form(nfft)) {
    if (ar == nullptr || ai == nullptr) return (int)cudaErrorInvalidValue;
    return tpufft_istft_ola(zr, zi, ar, ai, out, batch, nseg, hop, nperseg,
                            nfft / 2 + 1, bf16, stream);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(win);
  const auto* c_r = static_cast<const float*>(cr);
  const auto* c_i = static_cast<const float*>(ci);
  const auto* t = static_cast<const float2*>(tw);
  const auto* h = static_cast<const float2*>(half_tw);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return k14::launch_line_form(static_cast<const __nv_bfloat16*>(zr),
                                 static_cast<const __nv_bfloat16*>(zi), w,
                                 c_r, c_i, t, h, o, batch, nseg, hop, nperseg,
                                 nfft, st);
  return k14::launch_line_form(static_cast<const float*>(zr),
                               static_cast<const float*>(zi), w, c_r, c_i, t,
                               h, o, batch, nseg, hop, nperseg, nfft, st);
}

// Floats of K15's partials for these arguments (see tpufft_welch_frames),
// or minus a CUDA error.
extern "C" long long tpufft_welch_partial_floats(long long batch, int hop,
                                                 int nseg, int nperseg,
                                                 int nfft, int cross,
                                                 int bf16) {
  if (batch < 1 || hop < 1 || nseg < 1 || nperseg < 1 || nfft < 2 ||
      nperseg > nfft)
    return -(long long)cudaErrorInvalidValue;
  const int L = nfft % 2 ? nfft : nfft / 2;
  k13::WelchPlan p;
  const int err = k13::welch_form(bf16, nfft, cross, [&](auto t, auto packed,
                                                         auto crossed) {
    using T = std::remove_pointer_t<decltype(t)>;
    return k13::welch_plan<T, decltype(packed)::value,
                           decltype(crossed)::value>(batch, L, hop, nseg,
                                                     nperseg, &p);
  });
  if (err != 0) return -(long long)err;
  return (cross ? 2LL : 1LL) * batch * p.per_row * (nfft / 2 + 1);
}

// K15: x (and y when cross != 0) (batch, n_sig) f32 or bf16 (bf16 != 0),
// win (nperseg) f32, part scratch of tpufft_welch_partial_floats floats,
// outr (and outi when cross) (batch, nfft/2 + 1) f32: the sum over frames
// s < nseg (frame s of row b starts at b n_sig + s hop, with (nseg - 1) hop
// + nperseg <= n_sig and nperseg <= nfft) of |X_s|^2, or of conj(X_s) Y_s
// as (re, im), X_s the real DFT of frame s detrended (0 none, 1 constant,
// 2 linear), windowed and zero-padded to nfft. As for K13, with L = nfft/2
// for even nfft and L = nfft for odd: tw holds exp(-2 pi i k / L), k < L,
// radices[0:nstages] multiply to L (each 2, 4, 8 or an odd value up to
// 127), half_tw (read for even nfft) exp(-2 pi i k / nfft), k <= nfft/2.
// Returns 0 or a CUDA error.
extern "C" int tpufft_welch_frames(const void* x, const void* y,
                                   const void* win, void* part, void* outr,
                                   void* outi, const void* tw,
                                   const void* half_tw, long long batch,
                                   long long n_sig, int hop, int nseg,
                                   int nperseg, int nfft, int detrend,
                                   const int* radices, int nstages, int cross,
                                   int bf16, void* stream) {
  tpufft_fft::Radices plan;
  const int L = nfft % 2 ? nfft : nfft / 2;
  if (batch < 0 || hop < 1 || nseg < 1 || nperseg < 1 || nfft < 2 ||
      nperseg > nfft || detrend < 0 || detrend > 2 ||
      (int64_t)(nseg - 1) * hop + nperseg > n_sig ||
      !tpufft_fft::make_radices(L, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  return k13::welch_form(bf16, nfft, cross, [&](auto t, auto packed,
                                                auto crossed) {
    using T = std::remove_pointer_t<decltype(t)>;
    return k13::launch_welch<T, decltype(packed)::value,
                             decltype(crossed)::value>(
        x, y, static_cast<const float*>(win), static_cast<float*>(part),
        static_cast<float*>(outr), static_cast<float*>(outi),
        static_cast<const float2*>(tw), static_cast<const float2*>(half_tw),
        batch, n_sig, hop, nseg, nperseg, detrend, plan,
        static_cast<cudaStream_t>(stream));
  });
}
