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
// What bounds them on an H100: arithmetic. A dense product does 2 m_in
// flop per output for 8 bytes of device traffic (16 m_in for the complex
// form), hundreds of flop a byte at m_in = 512, far above the ~20
// flop/byte where the card's 67 TFLOP/s of FP32 FMA meets its memory rate.
//
// The real product (K11, K12) has two bodies (dense_mm.py:form mirrors
// the choice, which the wrapper passes in):
//   "tf32x3": where m_in and m_out are multiples of 4 and the operands
//       start on 16-byte boundaries, the 3xTF32 tensor-core tile loop of
//       tf32x3_mm.cuh: each f32 operand split into a TF32 big and small
//       part at the fragment load and three mma.sync products summed in
//       f32 (the TPU kernels' bf16x3 split, on the tensor cores), 128 x
//       128 block tiles, a ring of four 32-deep cp.async stages. Its
//       bound is three TF32 products at 495 TFLOP/s, 0.41 of the FP32
//       cores' bound for one f32 product.
//   "fma": every other shape (m_in or m_out of 2, 3, 7, 93, whose rows
//       break 16-byte copies), the shared-memory SGEMM of tile_mm.cuh
//       below.
// The complex product (K10) has the same two bodies, on the same rule:
//   "tf32x3": the complex product as one real product of twice the depth
//       and width, [Yr | Yi] = [Xr | Xi] [[Wr, Wi], [-Wi, Wr]], on the
//       tensor-core body above. The host builds the (2 m_in, 2 m_out)
//       block table once (dense_mm.py:block_table); the A loader reads
//       depth k < m_in from xr and the rest from xi (each 16-byte copy in
//       one plane, m_in being a multiple of 4), and the epilogue stores
//       column c < m_out to yr and the rest to yi, as float2 pairs (m_out
//       even). At (100000, 512) x (512, 512) it does K12's work at K12's
//       shape, (100000, 1024) x (1024, 1024).
//   "fma": the FMA tile loop of tile_mm.cuh: each block of 256 threads
//       computes a 128 x 64 tile of Y, staging 16-deep k-slices of X
//       (transposed) and W in shared memory, and each thread keeps an
//       8 x 4 register tile; it stages Xr, Xi, Wr and Wi for the same
//       k-slice and accumulates Yr = Xr Wr - Xi Wi and Yi = Xr Wi + Xi Wr
//       in registers, so X is read from device memory once per column
//       tile.
// Gauss's three-product form (one real product fewer, a sum whose
// rounding follows the larger of |Xr| and |Xi|) is not built.
// In every loop the column tiles of one row tile are neighbours in the
// launch order, so a row tile's re-reads of X come from L2, where W stays.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3_mm.cuh"
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

// Y = X W for real rows on the tensor cores (the "tf32x3" body): one
// 128 x 128 tile of Y a block, f32 results stored as float2 pairs.
constexpr int kTcStages = 4;

__global__ void __launch_bounds__(tf32x3::kThreads, 1)
dense_mm_tf32x3_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int64_t batch, int m_in, int m_out) {
  namespace tc = tf32x3;
  extern __shared__ __align__(16) float smem[];
  const int64_t row0 = (int64_t)blockIdx.y * tc::kBM;
  const int col0 = blockIdx.x * tc::kBN;
  tc::Acc acc;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int j = 0; j < tc::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  tc::accumulate<kTcStages>(smem, x + row0 * m_in, m_in, batch - row0,
                            w + col0, m_out, m_out - col0, m_in, acc);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t r0 = row0 + (warp / tc::kWarpsN) * tc::kWM + g;
  const int c0 = col0 + (warp % tc::kWarpsN) * tc::kWN + 2 * t;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int j = 0; j < tc::kNT; ++j) {
      const int c = c0 + j * 8;   // m_out is even: c < m_out covers c + 1
      if (c >= m_out) continue;
      const int64_t r = r0 + i * 16;
      if (r < batch)
        *reinterpret_cast<float2*>(y + r * m_out + c) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < batch)
        *reinterpret_cast<float2*>(y + (r + 8) * m_out + c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// [Yr | Yi] = [Xr | Xi] wb for complex planes on the tensor cores (K10's
// "tf32x3" body): wb the (2 m_in, 2 m_out) block table [[Wr, Wi], [-Wi,
// Wr]], one 128 x 128 tile of [Yr | Yi] a block.
__global__ void __launch_bounds__(tf32x3::kThreads, 1)
dense_mm_complex_tf32x3_kernel(const float* __restrict__ xr,
                               const float* __restrict__ xi,
                               const float* __restrict__ wb,
                               float* __restrict__ yr, float* __restrict__ yi,
                               int64_t batch, int m_in, int m_out) {
  namespace tc = tf32x3;
  extern __shared__ __align__(16) float smem[];
  const int64_t row0 = (int64_t)blockIdx.y * tc::kBM;
  const int col0 = blockIdx.x * tc::kBN;
  const int n2 = 2 * m_out;   // columns of [Yr | Yi] and of wb
  tc::Acc acc;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int j = 0; j < tc::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  tc::accumulate<kTcStages, true>(smem, xr + row0 * m_in, m_in, batch - row0,
                                  wb + col0, n2, n2 - col0, 2 * m_in, acc,
                                  xi + row0 * m_in, m_in);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t r0 = row0 + (warp / tc::kWarpsN) * tc::kWM + g;
  const int c0 = col0 + (warp % tc::kWarpsN) * tc::kWN + 2 * t;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int j = 0; j < tc::kNT; ++j) {
      const int c = c0 + j * 8;   // c even and m_out even: c + 1 in c's plane
      if (c >= n2) continue;
      float* y = c < m_out ? yr + c : yi + (c - m_out);
      const int64_t r = r0 + i * 16;
      if (r < batch)
        *reinterpret_cast<float2*>(y + r * m_out) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < batch)
        *reinterpret_cast<float2*>(y + (r + 8) * m_out) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The tensor-core bodies' launches: as launch() below, 128-row tiles of Y
// (of [Yr | Yi] when xi is given: the complex body, w then the block
// table).
int launch_tf32x3(const float* x, const float* xi, const float* w, float* y,
                  float* yi, long long batch, int m_in, int m_out,
                  cudaStream_t stream) {
  using tf32x3::kBM;
  using tf32x3::kBN;
  const bool cplx = xi != nullptr;
  if (batch < 0 || m_in < 4 || m_out < 4 || m_in % 4 || m_out % 4 ||
      misaligned(x) || misaligned(w) || misaligned(y) ||
      (cplx && (misaligned(xi) || yi == nullptr || misaligned(yi))))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tf32x3::smem_bytes<kTcStages>();
  cudaError_t err = cudaFuncSetAttribute(
      cplx ? (const void*)dense_mm_complex_tf32x3_kernel
           : (const void*)dense_mm_tf32x3_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = cplx ? 2 * m_out : m_out;
  const unsigned col_tiles = (unsigned)((cols + kBN - 1) / kBN);
  for (int64_t r = 0; r < batch; r += kMaxRowTiles * kBM) {
    const int64_t rows =
        batch - r < kMaxRowTiles * kBM ? batch - r : kMaxRowTiles * kBM;
    const dim3 grid(col_tiles, (unsigned)((rows + kBM - 1) / kBM));
    if (cplx)
      dense_mm_complex_tf32x3_kernel<<<grid, tf32x3::kThreads, smem,
                                       stream>>>(
          x + r * m_in, xi + r * m_in, w, y + r * m_out, yi + r * m_out, rows,
          m_in, m_out);
    else
      dense_mm_tf32x3_kernel<<<grid, tf32x3::kThreads, smem, stream>>>(
          x + r * m_in, w, y + r * m_out, rows, m_in, m_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
// current device, on `stream`. form 1 runs the 3xTF32 tensor-core body on
// wb, the (2 m_in, 2 m_out) block table [[Wr, Wi], [-Wi, Wr]] (m_in and
// m_out multiples of 4, every operand on a 16-byte boundary, else
// cudaErrorInvalidValue; wr and wi are not read), form 0 the FMA body on
// wr and wi (wb is not read). Returns 0 or the CUDA error of a launch.
extern "C" int tpufft_dense_mm_complex(const void* xr, const void* xi,
                                       const void* wr, const void* wi,
                                       const void* wb, void* yr, void* yi,
                                       long long batch, int m_in, int m_out,
                                       int form, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (form == 1)
    return launch_tf32x3(
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float*>(wb), static_cast<float*>(yr),
        static_cast<float*>(yi), batch, m_in, m_out, st);
  if (form != 0) return (int)cudaErrorInvalidValue;
  return launch<true>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<float*>(yr), static_cast<float*>(yi), batch, m_in, m_out,
      st);
}

// Y = X W for real rows and a real matrix (K11, and K12 with the DCT/DST
// table): x (batch, m_in), w (m_in, m_out), y (batch, m_out), f32 and
// contiguous. form 1 runs the 3xTF32 tensor-core body (m_in and m_out
// multiples of 4, operands on 16-byte boundaries, else
// cudaErrorInvalidValue), form 0 the FMA body. Returns 0 or the CUDA error
// of a launch.
extern "C" int tpufft_dense_mm_real(const void* x, const void* w, void* y,
                                    long long batch, int m_in, int m_out,
                                    int form, void* stream) {
  const auto xp = static_cast<const float*>(x);
  const auto wp = static_cast<const float*>(w);
  const auto yp = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form == 1)
    return launch_tf32x3(xp, nullptr, wp, yp, nullptr, batch, m_in, m_out,
                         st);
  if (form != 0) return (int)cudaErrorInvalidValue;
  return launch<false>(xp, nullptr, wp, nullptr, yp, nullptr, batch, m_in,
                       m_out, st);
}
