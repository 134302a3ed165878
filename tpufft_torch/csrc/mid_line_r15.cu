// Instantiation of the mid-pair kernel's generic-radix form (mid_line.cuh,
// mid_mixed_kernel) for n1 = 15 2^a from 15 to 240 (every n2 on the form's
// lists): one source a radix family of n1, so that nvcc builds the
// families in parallel.

#include "mid_line.cuh"

namespace tpufft_mid {

TPUFFT_MID_FAMILY(mixed_r15, 15)

}  // namespace tpufft_mid
