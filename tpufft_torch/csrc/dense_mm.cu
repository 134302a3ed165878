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
// rate. So the kernel is a classic shared-memory SGEMM, the tile loop of
// tile_mm.cuh: each block of 256 threads computes a 128 x 64 tile of Y,
// staging 16-deep k-slices of X (transposed) and W in shared memory, and
// each thread keeps an 8 x 4 register tile. The complex form stages Xr,
// Xi, Wr and Wi for the same k-slice and accumulates Yr = Xr Wr - Xi Wi
// and Yi = Xr Wi + Xi Wr in registers, so X is read from device memory
// once per column tile. Column tiles of one row tile are neighbours in the
// launch order, so a row tile's re-reads of X come from L2. Every product
// is an f32 FMA: no TF32 tensor cores, which keep about three decimal
// digits (a split 3xTF32 product on the tensor cores is the later
// redesign).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;

constexpr int kTM = 8;
constexpr int kBM = Tile<kTM>::BM;       // 128 rows of Y a block
constexpr int64_t kMaxRowTiles = 65535;  // gridDim.y limit

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
dense_mm_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ wi,
                float* __restrict__ yr, float* __restrict__ yi,
                int64_t batch, int m_in, int m_out) {
  using Op = std::conditional_t<kComplex, ComplexComplex, RealReal>;
  __shared__ __align__(16) Smem<kTM, Op::PA, Op::PB> sm;
  const float* xp[2] = {xr, xi};
  const float* wp[2] = {wr, wi};
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[Op::PC][kTM][4];
  zero(acc);
  accumulate<Op, kTM>(
      sm, m_in,
      [&](int q, int r, int k) {
        const int64_t row = row0 + r;
        return row < batch ? xp[q][row * m_in + k] : 0.f;
      },
      [&](int q, int k, int c) {
        return col0 + c < m_out ? wp[q][(int64_t)k * m_out + col0 + c] : 0.f;
      },
      acc);

  float* yp[2] = {yr, yi};
  const bool vec = (m_out % 4) == 0;   // 16-byte stores keep alignment
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + row_of(i, ty);
    if (row >= batch) continue;
#pragma unroll
    for (int q = 0; q < Op::PC; ++q)
      store4(yp[q] + row * m_out, col0 + tx * 4, m_out, vec, acc[q][i]);
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
