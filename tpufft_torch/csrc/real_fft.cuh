// Device code shared by the real-input transforms: K7's rfft (real_fft.cu)
// and K13's overlapped-frame STFT (stft_mm.cu), which both run the stages
// of a real row of even length n as m = n/2 complex values
// z[j] = x[2j] + i x[2j+1] and untangle the result.

#pragma once

#include "minor_fft.cuh"

namespace tpufft_real {

using namespace tpufft_fft;

// Bin k (0 <= k <= m) of the rfft of a real row of length n = 2m whose
// packed length-m DFT Z lies in buf at pad(row0 + j), j < m:
//   X[k] = (Z[k] + conj Z[m-k]) / 2 - i W^k (Z[k] - conj Z[m-k]) / 2,
// Z[m] = Z[0], with half_tw[k] = W^k = exp(-2 pi i k / n).
__device__ __forceinline__ float2 untangle(const float2* buf, int row0,
                                           int m, int k,
                                           const float2* __restrict__ half_tw) {
  const float2 a = buf[pad(row0 + (k == m ? 0 : k))];   // Z[k]
  const float2 b = buf[pad(row0 + (k == 0 ? 0 : m - k))];  // Z[m-k]
  const float2 s = make_float2(a.x + b.x, a.y - b.y);  // Z + conj Zm
  const float2 wd = cmul(__ldg(&half_tw[k]), make_float2(a.x - b.x, a.y + b.y));
  return make_float2(0.5f * (s.x + wd.y), 0.5f * (s.y - wd.x));  // - i wd
}

}  // namespace tpufft_real
