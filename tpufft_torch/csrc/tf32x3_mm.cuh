// A 3xTF32 tensor-core tile loop for f32 products on the H100: the block
// tile of C = A B for row-major A (rows, depth) and B (depth, cols), every
// product on `mma.sync.m16n8k8` TF32 tensor-core instructions with f32
// accumulators, accurate to about f32.
//
// The split (the Hopper form of the TPU kernels' bf16x3, mxu_fft.py
// _split_bf16 / _prep_real / _rdot3): each f32 operand v becomes
//   big   = v with its 13 low mantissa bits cleared (TF32, truncated: it
//           can never round up into Inf near FLT_MAX),
//   small = v - big (exact in f32), truncated to TF32 as well,
// and a b = a_small b_big + a_big b_small + a_big b_big, the small
// products issued first into the same partial sums (the order of
// CUTLASS's 3xTF32 and of the TPU kernel). The dropped a_small b_small
// and the small parts' truncation leave about 2^-20 of each product,
// against 2^-11 for one TF32 product, which fails the 1e-5 check; the f32
// accumulation's own rounding is of the same size (the numpy model in
// tests/test_torch_kernel_dense.py holds the split within 10x of the
// plain f32 product against float64). Rounding the small part to nearest
// instead (cvt.rna) can carry big + small of a value within 2^-22 of
// FLT_MAX up to 2^128, an Inf the f32 product does not give; truncation
// keeps |big + small| <= |v|.
//
// Inf and NaN: a non-finite v splits into big = 0, small = v, so v meets
// the other operand's big part (nonzero for every nonzero normal value)
// once, in a_small b_big or a_big b_small, and the product is a b's own
// Inf or NaN. (With big = v the cross terms would give Inf x 0 = NaN
// wherever the other operand is exactly a TF32 value, 1.0 or 0.5 say.)
// Where both operands are infinite the two cross terms give NaN in place
// of +-Inf; the callers' tables are finite.
//
// Geometry: a block of 256 threads (8 warps, 2 x 4, each a 64 x 32 warp
// tile of 4 x 4 m16n8 tiles) computes a 128 x 128 tile of C over 32-deep
// stages. A ring of kStages stages in dynamic shared memory is filled by
// 16-byte cp.async.cg copies (zero-filled past the rows' and the columns'
// ragged edges and past the depth), each thread 4 chunks of A and 4 of B
// a stage; stage s + kStages - 1 is in flight while stage s multiplies,
// with one __syncthreads a stage. A stage is stored A[128][32 + 4] and
// B[32][128 + 8]: a fragment load of the 32 lanes (g = lane / 4, t = lane
// % 4) reads A at bank (4 g + t) % 32 and B at bank (8 t + g) % 32, 32
// distinct banks each. Each thread splits its fragments as it loads them
// (24 values a k8 step), the next step's values loaded before this step's
// products. Per thread: 64 f32 sums of the tile, 64 of the stage's partial
// sums (below) and 48 split fragment words, about 200 registers, one
// block an SM.
//
// What bounds it (tools/dense_phases.py): the mma.sync TF32 rate. The
// three products alone take about 80 % of the kernel's time at (100000,
// 512) x (512, 512); the split costs most of the rest; the copies overlap.
// Splitting each stage once into shared memory (instead of at every
// fragment load, 4 and 2 times over for A and B) and 512-thread blocks
// of 32 x 32 warp tiles (more warps to hide latency, 127 registers) were
// both slower. The wgmma form (TF32 operands K-major in shared memory, a
// warpgroup pipeline) is the next step for this loop.
//
// The copies need 16-byte alignment: depth and cols multiples of 4 and
// the operands' bases on 16-byte boundaries (the caller chooses this
// body only then).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

constexpr int kBM = 128;        // rows of C a block
constexpr int kBN = 128;        // columns of C a block
constexpr int kBK = 32;         // depth of a stage
constexpr int kThreads = 256;   // 8 warps, 2 down the rows x 4 across
constexpr int kWM = 64;         // warp tile rows
constexpr int kWN = 32;         // warp tile columns
constexpr int kMT = kWM / 16;   // m16 tiles a warp
constexpr int kNT = kWN / 8;    // n8 tiles a warp
constexpr int kWarpsN = kBN / kWN;   // warps across the columns
// 16-byte copies of A a thread and stage, and as many of B
constexpr int kCopies = kBM * kBK / 4 / kThreads;
static_assert(kBN == kBM && kCopies * kThreads * 4 == kBM * kBK,
              "A and B stages of one size, whole copies a thread");
constexpr int kPitchA = kBK + 4;
constexpr int kPitchB = kBN + 8;
constexpr int kStageFloats = kBM * kPitchA + kBK * kPitchB;

template <int kStages>
constexpr int smem_bytes() {
  return kStages * kStageFloats * (int)sizeof(float);
}

// The TF32 big and small parts of v (see the header).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t keep = fabsf(v) <= 3.402823466e38f ? 0xffffe000u : 0u;
  big = u & keep;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// d += a b on one m16n8k8 TF32 tile, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from device to shared memory, or 16 zero bytes where !valid
// (src is then not read).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The accumulators of one thread: kMT x kNT m16n8 tiles, each c0..c3 at
// rows (g, g, g + 8, g + 8) and columns (2 t, 2 t + 1, 2 t, 2 t + 1) of
// the tile.
using Acc = float[kMT][kNT][4];

// acc += A[0:kBM, 0:depth] B[0:depth, 0:kBN] for one block tile. a: the
// tile's first row of A, pitch lda, `rows` of them valid (rows past them
// read as 0); b: the tile's first column of B, pitch ldb, `cols` valid.
// depth, lda, ldb, and the two bases must keep 16-byte copies aligned.
// smem: smem_bytes<kStages>() of dynamic shared memory.
//
// kTwoPlanes: A is two row-major planes of one pitch lda side by side,
// [A_lo | A_hi]: depth k < a_split reads a (A_lo), k >= a_split reads
// a_hi at k - a_split (a_hi: the tile's first row of A_hi). a_split must
// be a multiple of 4, so that each 16-byte copy lies in one plane. The
// default instantiation (one plane) compiles to the same code as before
// these arguments existed.
template <int kStages, bool kTwoPlanes = false>
__device__ __forceinline__ void accumulate(float* smem, const float* a,
                                           int64_t lda, int64_t rows,
                                           const float* b, int64_t ldb,
                                           int cols, int depth, Acc& acc,
                                           const float* a_hi = nullptr,
                                           int a_split = 0) {
  static_assert(kStages >= 2, "a ring of at least two stages");
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  // this thread's copies: A rows ra + i kThreads / 8 at depth ca, B
  // depth rows kb + i kThreads / 32 at column cb
  constexpr int kRowStep = kThreads / 8, kDepthStep = kThreads / 32;
  const int ra = tid / 8, ca = (tid % 8) * 4;
  const int kb = tid / 32, cb = (tid % 32) * 4;
  const float* a_src[kCopies];
  bool a_ok[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    a_ok[i] = ra + kRowStep * i < rows;
    a_src[i] = a + (a_ok[i] ? (ra + kRowStep * i) * lda : 0) + ca;
  }
  const bool b_col_ok = cb < cols;
  const float* b_src = b + (b_col_ok ? cb : 0);

  const int stages = (depth + kBK - 1) / kBK;
  auto load = [&](int s) {
    float* as = smem + (s % kStages) * kStageFloats;
    float* bs = as + kBM * kPitchA;
    const int k0 = s * kBK;
    const bool a_k = k0 + ca < depth;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool ok = a_ok[i] && a_k;
      if constexpr (kTwoPlanes) {
        // a_src + k0 + shift is A_hi's element at depth k0 + ca - a_split
        const int64_t shift =
            k0 + ca < a_split
                ? 0
                : (reinterpret_cast<intptr_t>(a_hi) -
                   reinterpret_cast<intptr_t>(a)) / (int64_t)sizeof(float) -
                      a_split;
        copy16(as + (ra + kRowStep * i) * kPitchA + ca,
               ok ? a_src[i] + k0 + shift : a, ok);
      } else {
        copy16(as + (ra + kRowStep * i) * kPitchA + ca,
               ok ? a_src[i] + k0 : a, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int k = k0 + kb + kDepthStep * i;
      const bool ok = b_col_ok && k < depth;
      copy16(bs + (kb + kDepthStep * i) * kPitchB + cb,
             ok ? b_src + (int64_t)k * ldb : b, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s);
    commit();   // empty groups keep the count of pending groups exact
  }
  for (int s = 0; s < stages; ++s) {
    wait_pending<kStages - 2>();   // this thread's copies of stage s landed
    __syncthreads();   // everyone's have, and stage s - 1 is free to refill
    if (s + kStages - 1 < stages) load(s + kStages - 1);
    commit();

    const float* as = smem + (s % kStages) * kStageFloats +
                      (wm * kWM + g) * kPitchA + t;
    const float* bs = smem + (s % kStages) * kStageFloats + kBM * kPitchA +
                      t * kPitchB + wn * kWN + g;
    // the stage's products go to a zeroed partial sum, added to acc once
    // a stage: the tensor cores' accumulation truncates, and 3 m_in / 8
    // truncating steps straight into acc pull it towards zero, by close
    // to 1e-5 at m_in = 1024 (tools/dense_phases.py, no_flush)
    float part[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    float fa[kMT][4], fb[kNT][2];
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* p = as + i * 16 * kPitchA + k;
        fa[i][0] = p[0];
        fa[i][1] = p[8 * kPitchA];
        fa[i][2] = p[4];
        fa[i][3] = p[8 * kPitchA + 4];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* p = bs + k * kPitchB + j * 8;
        fb[j][0] = p[0];
        fb[j][1] = p[4 * kPitchB];
      }
    };
    fetch(0);
#pragma unroll
    for (int k = 0; k < kBK; k += 8) {
      uint32_t a_big[kMT][4], a_small[kMT][4];
      uint32_t b_big[kNT][2], b_small[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) split(fa[i][q], a_big[i][q], a_small[i][q]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) split(fb[j][q], b_big[j][q], b_small[j][q]);
      if (k + 8 < kBK) fetch(k + 8);   // in flight during the products
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  wait_pending<0>();   // no copy outlives the loop (only empty groups remain)
}

}  // namespace tf32x3
