// Batched dense matrix product Y = X W along the contiguous minor axis, with
// plain C entry points for ctypes (tpufft_torch/kernels/dense_mm.py binds
// and checks them).
//
// Replaces three Pallas TPU kernels, which share one contract: a batch of
// rows times one (m_in, m_out) matrix built on the host, scale folded in.
//   K10 tpufft/kernels/mxu_fft.py build_minor_dense: complex planes
//       (batch, m_in) times a complex matrix (the fused circulant of
//       signal.plan_filter, which hilbert reaches too);
//   K11 mxu_fft.py build_minor_dense_real: real rows times a real matrix
//       (a Hermitian-response filter on real input);
//   K12 tpufft/realtrans.py _build_minor_r2r: real rows times the DCT/DST
//       matrix of realtrans._mat (the real kernel with that table).
// X (batch, m_in), W (m_in, m_out) and Y (batch, m_out) are f32, row-major
// and contiguous; any lengths, ragged edges masked.
//
// What bounds them on an H100: FP32 arithmetic. A dense product does
// 2 m_in flop per output for 8 bytes of device traffic (16 m_in for the
// complex form), hundreds of flop a byte at m_in = 512, far above the
// ~20 flop/byte where the card's 67 TFLOP/s of FP32 FMA meets its memory
// rate. So the kernel is a classic shared-memory SGEMM: each block of 256
// threads computes a 128 x 64 tile of Y, staging 16-deep k-slices of X
// (transposed) and W in shared memory, and each thread keeps an 8 x 4
// register tile, fed by two 16-byte shared loads of X and one of W per k.
// The complex form stages Xr, Xi, Wr and Wi for the same k-slice and
// accumulates Yr = Xr Wr - Xi Wi and Yi = Xr Wi + Xi Wr in registers, so X
// is read from device memory once per column tile. Column tiles of one row
// tile are neighbours in the launch order, so a row tile's re-reads of X
// come from L2. Every product is an f32 FMA: no TF32 tensor cores, which
// keep about three decimal digits (a split 3xTF32 product on the tensor
// cores is the later redesign).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;          // rows of Y a block
constexpr int kBN = 64;           // columns of Y a block
constexpr int kBK = 16;           // depth of a k-slice
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 4 outputs each
constexpr int kPitch = kBM + 4;   // X slice row pitch: 2-way store conflicts
constexpr int64_t kMaxRowTiles = 65535;  // gridDim.y limit

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
dense_mm_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ wi,
                float* __restrict__ yr, float* __restrict__ yi,
                int64_t batch, int m_in, int m_out) {
  constexpr int P = kComplex ? 2 : 1;   // planes: re (and im)
  __shared__ __align__(16) float xs[P][kBK][kPitch];
  __shared__ __align__(16) float ws[P][kBK][kBN];
  const float* xp[2] = {xr, xi};
  const float* wp[2] = {wr, wi};

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // rows ty*4 .. +3 and 64+ty*4 .. +3
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[P][8][4];
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

  for (int k0 = 0; k0 < m_in; k0 += kBK) {
    // X slice, 128 rows x 16 k, stored transposed; a warp reads two rows
    // of 16 consecutive k
#pragma unroll
    for (int p = 0; p < kBM * kBK / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int64_t row = row0 + r;
      const bool ok = row < batch && k0 + c < m_in;
      const int64_t off = row * m_in + k0 + c;
#pragma unroll
      for (int q = 0; q < P; ++q) xs[q][c][r] = ok ? xp[q][off] : 0.f;
    }
    // W slice, 16 k x 64 columns; a warp reads 32 consecutive columns
#pragma unroll
    for (int p = 0; p < kBK * kBN / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int kk = idx / kBN, cc = idx % kBN;
      const bool ok = k0 + kk < m_in && col0 + cc < m_out;
      const int64_t off = (int64_t)(k0 + kk) * m_out + col0 + cc;
#pragma unroll
      for (int q = 0; q < P; ++q) ws[q][kk][cc] = ok ? wp[q][off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[P][8], b[P][4];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float4 lo = *reinterpret_cast<const float4*>(&xs[q][k][ty * 4]);
        const float4 hi =
            *reinterpret_cast<const float4*>(&xs[q][k][64 + ty * 4]);
        const float4 bw = *reinterpret_cast<const float4*>(&ws[q][k][tx * 4]);
        a[q][0] = lo.x; a[q][1] = lo.y; a[q][2] = lo.z; a[q][3] = lo.w;
        a[q][4] = hi.x; a[q][5] = hi.y; a[q][6] = hi.z; a[q][7] = hi.w;
        b[q][0] = bw.x; b[q][1] = bw.y; b[q][2] = bw.z; b[q][3] = bw.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kComplex) {
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
            acc[0][i][j] = fmaf(-a[1][i], b[1][j], acc[0][i][j]);
            acc[1][i][j] = fmaf(a[0][i], b[1][j], acc[1][i][j]);
            acc[1][i][j] = fmaf(a[1][i], b[0][j], acc[1][i][j]);
          } else {
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
          }
        }
    }
    __syncthreads();
  }

  float* yp[2] = {yr, yi};
  const bool vec = (m_out % 4) == 0;   // 16-byte stores keep alignment
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= batch) continue;
    const int col = col0 + tx * 4;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float* out = yp[q] + row * m_out;
      if (vec && col + 3 < m_out) {
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[q][i][0], acc[q][i][1], acc[q][i][2],
                        acc[q][i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < m_out) out[col + j] = acc[q][i][j];
      }
    }
  }
}

template <bool kComplex>
int launch(const float* xr, const float* xi, const float* wr, const float* wi,
           float* yr, float* yi, long long batch, int m_in, int m_out,
           cudaStream_t stream) {
  if (batch < 0 || m_in < 1 || m_out < 1) return (int)cudaErrorInvalidValue;
  const unsigned col_tiles = (unsigned)((m_out + kBN - 1) / kBN);
  // row tiles in gridDim.y (at most 65535 a launch): a longer batch runs
  // in several launches over consecutive row ranges
  for (int64_t r = 0; r < batch; r += kMaxRowTiles * kBM) {
    const int64_t rows =
        batch - r < kMaxRowTiles * kBM ? batch - r : kMaxRowTiles * kBM;
    const dim3 grid(col_tiles, (unsigned)((rows + kBM - 1) / kBM));
    dense_mm_kernel<kComplex><<<grid, kThreads, 0, stream>>>(
        xr + r * m_in, kComplex ? xi + r * m_in : nullptr, wr, wi,
        yr + r * m_out, kComplex ? yi + r * m_out : nullptr, rows, m_in,
        m_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Y = X W for complex planes (K10): xr/xi (batch, m_in), wr/wi
// (m_in, m_out), yr/yi (batch, m_out), all f32 and contiguous on the
// current device, on `stream`. Returns 0 or the CUDA error of a launch.
extern "C" int tpufft_dense_mm_complex(const void* xr, const void* xi,
                                       const void* wr, const void* wi,
                                       void* yr, void* yi, long long batch,
                                       int m_in, int m_out, void* stream) {
  return launch<true>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<float*>(yr), static_cast<float*>(yi), batch, m_in, m_out,
      static_cast<cudaStream_t>(stream));
}

// Y = X W for real rows and a real matrix (K11, and K12 with the DCT/DST
// table): x (batch, m_in), w (m_in, m_out), y (batch, m_out), f32 and
// contiguous. Returns 0 or the CUDA error of a launch.
extern "C" int tpufft_dense_mm_real(const void* x, const void* w, void* y,
                                    long long batch, int m_in, int m_out,
                                    void* stream) {
  return launch<false>(static_cast<const float*>(x), nullptr,
                       static_cast<const float*>(w), nullptr,
                       static_cast<float*>(y), nullptr, batch, m_in, m_out,
                       static_cast<cudaStream_t>(stream));
}
