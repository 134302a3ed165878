// Instantiation of the mid-pair kernel's generic-radix form (mid_line.cuh,
// mid_mixed_kernel) for n1 = 2^a from 2 to 256 (every n2 on the form's
// lists): one source a radix family of n1, so that nvcc builds the
// families in parallel.

#include "mid_line.cuh"

namespace tpufft_mid {

TPUFFT_MID_FAMILY(mixed_pow2, 1)

}  // namespace tpufft_mid
