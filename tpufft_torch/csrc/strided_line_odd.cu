// Instantiations of the strided-axis line form (strided_line.cuh) at
// the lengths 25, 93 (3 x 31: a 31-long line in one lane, its outputs
// stored as the conjugate-pair sum forms them) and 1080 (f32 only);
// line_split there lists each length's four-step.

#include <type_traits>

#include "strided_line.cuh"

namespace tpufft_strided {

template <typename T, bool kFused>
int launch_line_odd(const LineArgs& a, const LineGeometry& g) {
  switch (g.n1 * g.n2) {
    case 25:
      return launch_lines<T, 25, kFused>(a, g);
    case 93:
      return launch_lane<T, 3, 31, kFused>(a, g);
    case 1080:
      if constexpr (std::is_same<T, float>::value)
        return launch_lane<T, 30, 36, kFused>(a, g);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template int launch_line_odd<float, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_odd<float, true>(
    const LineArgs&, const LineGeometry&);
template int launch_line_odd<__nv_bfloat16, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_odd<__nv_bfloat16, true>(
    const LineArgs&, const LineGeometry&);

}  // namespace tpufft_strided
