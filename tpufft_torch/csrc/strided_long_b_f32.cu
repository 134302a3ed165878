// Instantiations of the strided-axis cluster form (strided_long.cuh) at
// the lengths 4320 to 16384 of the list TPUFFT_STRIDED_LONG_B there, in f32
// storage (plain, with tw_nm and on fused storage), in a source of its own
// so that nvcc builds it beside the other lists and storages.

#include <type_traits>

#include "strided_long.cuh"

namespace tpufft_strided {

TPUFFT_LONG_FAMILY(launch_cluster_b, TPUFFT_STRIDED_LONG_B, float)

}  // namespace tpufft_strided
