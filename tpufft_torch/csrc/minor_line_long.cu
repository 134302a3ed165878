// Instantiations of the minor-axis line form's three-factor kernel
// (minor_fft.cuh, LongStep, launch_three_factor) at the lengths of
// TPUFFT_MINOR_LONG there (4320 to 16384), for K1, K20 and K9 in f32 and
// bf16 storage, in a source of their own so that nvcc builds them beside
// the other families.

#include "minor_fft.cuh"

namespace tpufft_minor {

#define TPUFFT_LONG_CASE(n_, n1, n2, n3, th, p1, p2)                      \
  case n_:                                                                \
    return launch_three_factor<T, LongStep<n1, n2, n3, th, p1, p2>,       \
                               kFused, kPadded>(a);

template <typename T, bool kFused, bool kPadded>
int launch_long(const LaneArgs& a, int n) {
  switch (n) { TPUFFT_MINOR_LONG(TPUFFT_LONG_CASE) }
  return (int)cudaErrorInvalidValue;
}

template int launch_long<float, false, false>(const LaneArgs&, int);
template int launch_long<float, true, false>(const LaneArgs&, int);
template int launch_long<float, false, true>(const LaneArgs&, int);
template int launch_long<__nv_bfloat16, false, false>(const LaneArgs&, int);
template int launch_long<__nv_bfloat16, true, false>(const LaneArgs&, int);
template int launch_long<__nv_bfloat16, false, true>(const LaneArgs&, int);

}  // namespace tpufft_minor
