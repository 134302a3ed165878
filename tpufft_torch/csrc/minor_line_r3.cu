// Instantiations of the minor-axis line form's four-step (minor_fft.cuh,
// launch_four_step) at the mixed-radix lengths of TPUFFT_MINOR_R3 there,
// for K1, K20 and K9 in f32 and bf16 storage: one source a radix family,
// so that nvcc builds the families in parallel.

#include "minor_fft.cuh"

namespace tpufft_minor {

TPUFFT_MINOR_FAMILY(launch_mixed_r3, TPUFFT_MINOR_R3)

}  // namespace tpufft_minor
