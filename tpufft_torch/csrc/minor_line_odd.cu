// Instantiations of the minor-axis line form's four-step (minor_fft.cuh,
// launch_four_step) at the mixed-radix lengths of TPUFFT_MINOR_ODD there,
// for K1, K20 and K9 in f32 and bf16 storage: one source a radix family,
// so that nvcc builds the families in parallel.

#include "minor_fft.cuh"

namespace tpufft_minor {

TPUFFT_MINOR_FAMILY(launch_mixed_odd, TPUFFT_MINOR_ODD)

}  // namespace tpufft_minor
