// Instantiations of the real-input kernels' mixed-radix line form
// (real_fft.cuh: K7's rfft and K8's irfft on K1's four-step) at
// the halves of TPUFFT_REAL_R5 there, in f32 and bf16 storage: one source a
// radix family, so that nvcc builds the families in parallel.

#include "real_fft.cuh"

namespace tpufft_real {

TPUFFT_REAL_FAMILY(launch_real_r5, TPUFFT_REAL_R5, TPUFFT_REAL_NONE)

}  // namespace tpufft_real
