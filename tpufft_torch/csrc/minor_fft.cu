// Host entry points of the batched minor-axis C2C FFT (K1, K9) and of its
// fused-storage form (K20), with a plain C interface for ctypes
// (tpufft_torch/_build.py builds this file; tpufft_torch/kernels/
// minor_fft.py and fused_fft.py bind and check it). The kernel's two forms
// and their design notes are in minor_fft.cuh; launch_sized picks the form.

#include <climits>

#include "minor_fft.cuh"

using namespace tpufft_minor;

namespace {

template <typename T, int kThreads, int kPer, int kMinBlocks, bool kPadded,
          bool kFused>
int launch(const void* xr, const void* xi, void* yr, void* yi, const void* tw,
           long long batch, const Radices& plan, const Geometry& g, int n_in,
           int inverse, float scale, cudaStream_t stream) {
  auto* kernel =
      minor_fft_kernel<T, kThreads, kPer, kMinBlocks, kPadded, kFused>;
  if (g.threads > kThreads || g.per != kPer) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + g.rows - 1) / g.rows;
  kernel<<<(unsigned)blocks, g.threads, g.smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(yr), static_cast<T*>(yi),
      static_cast<const float2*>(tw), (int64_t)batch, plan, g.rows, n_in,
      inverse, scale);
  return (int)cudaGetLastError();
}

// The line form at n <= 64: one kernel of 128 threads, each warp W K rows
// (K9, kPadded: the padded kernel on rows of n_in).
template <typename T, int N, bool kFused, bool kPadded>
int launch_lines(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw, long long batch, int n_in, int inverse,
                 float scale, cudaStream_t stream) {
  constexpr int kThreads = 128;
  using L = tpufft_line::Line<N>;
  constexpr long long rows =
      (kThreads / 32) * L::W * (kLineLaneValues / L::V);
  const long long blocks = (batch + rows - 1) / rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const T* x_r = static_cast<const T*>(xr);
  const T* x_i = static_cast<const T*>(xi);
  T* y_r = static_cast<T*>(yr);
  T* y_i = static_cast<T*>(yi);
  const float2* w = static_cast<const float2*>(tw);
  if constexpr (kPadded)
    minor_lines_padded_kernel<T, N, kThreads>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            x_r, x_i, y_r, y_i, w, (int64_t)batch, n_in, inverse, scale);
  else
    minor_lines_kernel<T, N, kThreads, kFused>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            x_r, x_i, y_r, y_i, w, (int64_t)batch, inverse, scale);
  return (int)cudaGetLastError();
}

// The power-of-two four-step at 128 <= n <= 2048 (LaneStep's XOR tile,
// 32 values a lane; K9, kPadded: the padded kernel).
template <typename T, int N1, int N2, int kTeamWarps, int kThreads,
          bool kFused, bool kPadded>
int launch_lane(const LaneArgs& a) {
  using S = LaneStep<N1, N2, kTeamWarps, kThreads,
                     1024 * kTeamWarps / (N1 * N2), N2, N1, 0, 0>;
  return launch_four_step<T, S, kThreads, kFused, kPadded>(a);
}

// The line form: power-of-two n from 2 to 2048 (the four-steps of
// TPUFFT_MINOR_POW2 from 128), the mixed-radix lengths of minor_fft.cuh's
// family lists and the three-factor lengths of TPUFFT_MINOR_LONG (4096
// among them).
template <typename T, bool kFused, bool kPadded>
int launch_line_form(const void* xr, const void* xi, void* yr, void* yi,
                     const void* tw, long long batch, int n, int n_in,
                     int inverse, float scale, cudaStream_t stream) {
  const LaneArgs a{xr, xi, yr, yi, tw, batch, n_in, inverse, scale, stream};
#define TPUFFT_LINES(N)                                                   \
  launch_lines<T, N, kFused, kPadded>(xr, xi, yr, yi, tw, batch, n_in,    \
                                      inverse, scale, stream)
#define TPUFFT_LANE(n_, N1, N2, TW, TH) \
  case n_:                              \
    return launch_lane<T, N1, N2, TW, TH, kFused, kPadded>(a);
  switch (n) {
    case 2: return TPUFFT_LINES(2);
    case 4: return TPUFFT_LINES(4);
    case 8: return TPUFFT_LINES(8);
    case 16: return TPUFFT_LINES(16);
    case 32: return TPUFFT_LINES(32);
    case 64: return TPUFFT_LINES(64);
    TPUFFT_MINOR_POW2(TPUFFT_LANE)
  }
#undef TPUFFT_LINES
#undef TPUFFT_LANE
  if (three_factor(n)) return launch_long<T, kFused, kPadded>(a, n);
  return launch_mixed<T, kFused, kPadded>(a, n);
}

// Is n a length of the line form? (K1, K20 and K9 alike.)
inline bool line_form(int n) {
  return (n >= 2 && n <= kLineMaxN && (n & (n - 1)) == 0) ||
         mixed_family(n) != 0 || three_factor(n);
}

// The line form where n is one of its lengths, else the stage form;
// `stages` forces the stage form (kept to compare the forms).
template <typename T, bool kPadded, bool kFused>
int launch_sized(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw, long long batch, const Radices& plan,
                 int n_in, int inverse, float scale, bool stages,
                 cudaStream_t stream) {
  if (!stages && line_form(plan.n))
    return launch_line_form<T, kFused, kPadded>(
        xr, xi, yr, yi, tw, batch, plan.n, n_in, inverse, scale, stream);
  const Geometry g = launch_geometry(plan.n);
  if (g.per == 8)
    return launch<T, 512, 8, 2, kPadded, kFused>(
        xr, xi, yr, yi, tw, batch, plan, g, n_in, inverse, scale, stream);
  return launch<T, 1024, 16, 1, kPadded, kFused>(
      xr, xi, yr, yi, tw, batch, plan, g, n_in, inverse, scale, stream);
}

template <typename T>
int launch_typed(const void* xr, const void* xi, void* yr, void* yi,
                 const void* tw, long long batch, const Radices& plan,
                 int n_in, int inverse, float scale, bool stages,
                 cudaStream_t stream) {
  if (n_in == plan.n)
    return launch_sized<T, false, false>(xr, xi, yr, yi, tw, batch, plan,
                                         n_in, inverse, scale, stages,
                                         stream);
  return launch_sized<T, true, false>(xr, xi, yr, yi, tw, batch, plan, n_in,
                                      inverse, scale, stages, stream);
}

// K20: the rows of st and out are fused storage, their two planes st and
// st + n (out and out + n) with row stride 2n.
template <typename T>
int launch_fused(const void* st, void* out, const void* tw, long long batch,
                 const Radices& plan, int inverse, float scale,
                 cudaStream_t stream) {
  const T* x = static_cast<const T*>(st);
  T* y = static_cast<T*>(out);
  const int n = plan.n;
  return launch_sized<T, false, true>(x, x + n, y, y + n, tw, batch, plan, n,
                                      inverse, scale, false, stream);
}

int minor_entry(const void* xr, const void* xi, void* yr, void* yi,
                const void* tw, long long batch, int n, int n_in,
                const int* radices, int nstages, int inverse, float scale,
                int bf16, bool stages, void* stream) {
  Radices plan;
  if (batch < 0 || n_in < 1 || n_in > n ||
      !make_radices(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(xr, xi, yr, yi, tw, batch, plan, n_in,
                                       inverse, scale, stages, s);
  return launch_typed<float>(xr, xi, yr, yi, tw, batch, plan, n_in, inverse,
                             scale, stages, s);
}

}  // namespace

// Transforms the (batch, n_in) planes xr/xi, zero-padded to length n, into
// the (batch, n) planes yr/yi (f32, or bf16 when bf16 != 0) on `stream`, a
// stream of the current device; n_in == n is the plain C2C transform (K1),
// 1 <= n_in < n the fused zero-pad DFT (K9). tw holds the n complex f32
// values exp(-+2 pi i k / n) for the direction; radices[0:nstages] multiply
// to n, each 2, 4, 8 or an odd value up to 127 (the stage form's plan; the
// line form, which K1 and K9 run at power-of-two n from 2 to 4096 and at
// the mixed-radix and three-factor lengths of minor_fft.cuh's family
// lists, ignores it).
// Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_minor_fft(const void* xr, const void* xi, void* yr,
                                void* yi, const void* tw, long long batch,
                                int n, int n_in, const int* radices,
                                int nstages, int inverse, float scale,
                                int bf16, void* stream) {
  return minor_entry(xr, xi, yr, yi, tw, batch, n, n_in, radices, nstages,
                     inverse, scale, bf16, false, stream);
}

// K20: the same transform on fused storage. Transforms the (batch, 2n)
// array st, each row [re(0..n-1) | im(0..n-1)], into `out` of the same
// shape; tw, radices, inverse, scale, bf16 and stream as for
// tpufft_minor_fft. Returns 0 or the CUDA error code of the launch.
extern "C" int tpufft_minor_fft_fused(const void* st, void* out,
                                      const void* tw, long long batch, int n,
                                      const int* radices, int nstages,
                                      int inverse, float scale, int bf16,
                                      void* stream) {
  Radices plan;
  if (batch < 0 || !make_radices(n, radices, nstages, &plan))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fused<__nv_bfloat16>(st, out, tw, batch, plan, inverse,
                                       scale, s);
  return launch_fused<float>(st, out, tw, batch, plan, inverse, scale, s);
}

// K1 (n_in == n) and K9 (1 <= n_in < n) on the stage form at every
// length, kept to compare the forms; arguments and result as for
// tpufft_minor_fft.
extern "C" int tpufft_minor_fft_stages(const void* xr, const void* xi,
                                       void* yr, void* yi, const void* tw,
                                       long long batch, int n, int n_in,
                                       const int* radices, int nstages,
                                       int inverse, float scale, int bf16,
                                       void* stream) {
  return minor_entry(xr, xi, yr, yi, tw, batch, n, n_in, radices, nstages,
                     inverse, scale, bf16, true, stream);
}

// The form the launch runs at length n (K1, K9 and K20 alike): 0 the stage
// form, 1 the line form of a row on the lanes of one warp (power-of-two n
// up to 64), 2 the four-step, with out[0:9] = {N1, N2, warps a team,
// threads a block, rows a team, Q1, Q2, P2, RS} (LaneStep's parameters;
// P2 = RS = 0 for the power-of-two XOR tile), 3 the three-factor form,
// with out[0:6] = {N1, N2, N3, threads a block, P1, P2} (LongStep's).
extern "C" int tpufft_minor_line_geometry(int n, int* out) {
  if (!line_form(n)) return 0;
  if (n <= 64 && (n & (n - 1)) == 0) return 1;
#define TPUFFT_LONG_GEO(n_, n1, n2, n3, th, p1, p2) \
  if (n == n_) {                                    \
    const int v[6] = {n1, n2, n3, th, p1, p2};      \
    for (int i = 0; i < 6; ++i) out[i] = v[i];      \
    return 3;                                       \
  }
  TPUFFT_MINOR_LONG(TPUFFT_LONG_GEO)
#undef TPUFFT_LONG_GEO
#define TPUFFT_GEO(n_, n1, n2, w, r, q1, q2, p2, rs)           \
  if (n == n_) {                                               \
    const int v[9] = {n1, n2, w, 128, r, q1, q2, p2, rs};      \
    for (int i = 0; i < 9; ++i) out[i] = v[i];                 \
    return 2;                                                  \
  }
#define TPUFFT_POW2_GEO(n_, n1, n2, w, th)                        \
  if (n == n_) {                                                  \
    const int v[9] = {n1, n2, w, th, 1024 * w / n_, n2, n1, 0, 0}; \
    for (int i = 0; i < 9; ++i) out[i] = v[i];                    \
    return 2;                                                     \
  }
  TPUFFT_MINOR_POW2(TPUFFT_POW2_GEO)
#undef TPUFFT_POW2_GEO
  TPUFFT_MINOR_R3(TPUFFT_GEO)
  TPUFFT_MINOR_R5(TPUFFT_GEO)
  TPUFFT_MINOR_R15(TPUFFT_GEO)
  TPUFFT_MINOR_ODD(TPUFFT_GEO)
#undef TPUFFT_GEO
  return 0;
}
