// The shared-memory SGEMM tile loop of the port's dense-matrix kernels:
// dense_mm.cu (K10, K11, K12) and stft_mm.cu (K14; K13 and K15 use to_f32).
//
// A block of 256 threads computes a BM x 64 tile of a product A B, with
// BM = 16 TM rows: each thread keeps a TM x 4 register tile per output
// plane (rows ty*4 .. ty*4+3, then 64 + ty*4 .. for TM = 8; columns
// tx*4 .. tx*4+3). The depth runs in 16-deep slices; each slice stages A
// (transposed, one float per thread and row group) and B in shared memory,
// and every product is an f32 FMA on the CUDA cores (no TF32, which keeps
// about three decimal digits). The kernels differ only in where A's rows
// come from (contiguous rows, shifted spectrum segments), in the planes
// they multiply (an Op below) and in their epilogue, so each passes its own
// loaders to accumulate().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tile_mm {

constexpr int kBN = 64;         // columns of the product a block
constexpr int kBK = 16;         // depth of a slice
constexpr int kThreads = 256;   // 16 x 16 threads

template <int TM>
struct Tile {
  static constexpr int BM = 16 * TM;     // rows of the product a block
  static constexpr int Pitch = BM + 4;   // A slice row pitch: 2-way stores
};

// Tile row of the thread in thread-row ty at register row i.
__device__ __forceinline__ int row_of(int i, int ty) {
  return (i >> 2) * 64 + ty * 4 + (i & 3);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The products of one depth step: a[PA][TM] (A's planes at the thread's
// rows) and b[PB][4] (B's planes at its columns) into c[PC][TM][4].
struct RealReal {          // y = x w (K11, K12)
  static constexpr int PA = 1, PB = 1, PC = 1;
  template <int TM>
  __device__ __forceinline__ static void fma(const float (&a)[PA][TM],
                                             const float (&b)[PB][4],
                                             float (&c)[PC][TM][4]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[0][i][j] = fmaf(a[0][i], b[0][j], c[0][i][j]);
  }
};

struct ComplexComplex {    // yr = xr wr - xi wi, yi = xr wi + xi wr (K10)
  static constexpr int PA = 2, PB = 2, PC = 2;
  template <int TM>
  __device__ __forceinline__ static void fma(const float (&a)[PA][TM],
                                             const float (&b)[PB][4],
                                             float (&c)[PC][TM][4]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[0][i][j] = fmaf(a[0][i], b[0][j], c[0][i][j]);
        c[0][i][j] = fmaf(-a[1][i], b[1][j], c[0][i][j]);
        c[1][i][j] = fmaf(a[0][i], b[1][j], c[1][i][j]);
        c[1][i][j] = fmaf(a[1][i], b[0][j], c[1][i][j]);
      }
  }
};

struct RealPart {          // y = zr ar + zi ai, the real part of z conj(a) (K14)
  static constexpr int PA = 2, PB = 2, PC = 1;
  template <int TM>
  __device__ __forceinline__ static void fma(const float (&a)[PA][TM],
                                             const float (&b)[PB][4],
                                             float (&c)[PC][TM][4]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[0][i][j] = fmaf(a[0][i], b[0][j], c[0][i][j]);
        c[0][i][j] = fmaf(a[1][i], b[1][j], c[0][i][j]);
      }
  }
};

template <int TM, int PA, int PB>
struct Smem {
  float xs[PA][kBK][Tile<TM>::Pitch];   // A slice, transposed
  float ws[PB][kBK][kBN];               // B slice
};

template <int P, int TM>
__device__ __forceinline__ void zero(float (&acc)[P][TM][4]) {
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
}

// acc += A[0:BM, 0:depth] B[0:depth, 0:64] for one block tile.
// a_at(q, r, k): plane q of A at tile row r and depth k < depth, 0 past
// the rows' ragged edge. b_at(q, k, c): plane q of B at depth k < depth
// and tile column c, 0 past the columns' edge. The depth's edge is masked
// here. A warp stages two rows of 16 consecutive depths of A and 32
// consecutive columns of B.
template <class Op, int TM, class AAt, class BAt>
__device__ __forceinline__ void accumulate(Smem<TM, Op::PA, Op::PB>& sm,
                                           int depth, AAt a_at, BAt b_at,
                                           float (&acc)[Op::PC][TM][4]) {
  constexpr int BM = Tile<TM>::BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < depth; k0 += kBK) {
#pragma unroll
    for (int p = 0; p < BM * kBK / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const bool ok = k0 + c < depth;
#pragma unroll
      for (int q = 0; q < Op::PA; ++q)
        sm.xs[q][c][r] = ok ? a_at(q, r, k0 + c) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kBK * kBN / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int kk = idx / kBN, cc = idx % kBN;
      const bool ok = k0 + kk < depth;
#pragma unroll
      for (int q = 0; q < Op::PB; ++q)
        sm.ws[q][kk][cc] = ok ? b_at(q, k0 + kk, cc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[Op::PA][TM], b[Op::PB][4];
#pragma unroll
      for (int q = 0; q < Op::PA; ++q)
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(&sm.xs[q][k][h * 64 + ty * 4]);
          a[q][h * 4 + 0] = v.x;
          a[q][h * 4 + 1] = v.y;
          a[q][h * 4 + 2] = v.z;
          a[q][h * 4 + 3] = v.w;
        }
#pragma unroll
      for (int q = 0; q < Op::PB; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.ws[q][k][tx * 4]);
        b[q][0] = v.x;
        b[q][1] = v.y;
        b[q][2] = v.z;
        b[q][3] = v.w;
      }
      Op::template fma<TM>(a, b, acc);
    }
    __syncthreads();
  }
}

// Columns col .. col+3 of one output row, masked at ncols; one 16-byte
// store where the row allows it (vec: the row pitch and base keep 16-byte
// alignment).
__device__ __forceinline__ void store4(float* row, int col, int ncols,
                                       bool vec, const float (&v)[4]) {
  if (vec && col + 3 < ncols) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < ncols) row[col + j] = v[j];
  }
}

}  // namespace tile_mm
