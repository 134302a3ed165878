// Instantiation of the mid-pair kernel's generic-radix form (mid_line.cuh,
// mid_mixed_kernel) for n1 = 3 2^a from 3 to 192 (every n2 on the form's
// lists): one source a radix family of n1, so that nvcc builds the
// families in parallel.

#include "mid_line.cuh"

namespace tpufft_mid {

TPUFFT_MID_FAMILY(mixed_r3, 3)

}  // namespace tpufft_mid
