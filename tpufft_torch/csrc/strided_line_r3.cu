// Instantiations of the strided-axis line form (strided_line.cuh) at
// the lengths 3 2^a from 12 to 1536;
// line_split there lists each length's four-step.

#include <type_traits>

#include "strided_line.cuh"

namespace tpufft_strided {

template <typename T, bool kFused>
int launch_line_r3(const LineArgs& a, const LineGeometry& g) {
  switch (g.n1 * g.n2) {
    case 12:
      return launch_lines<T, 12, kFused>(a, g);
    case 24:
      return launch_lines<T, 24, kFused>(a, g);
    case 48:
      return launch_lane<T, 12, 4, kFused>(a, g);
    case 96:
      return launch_lane<T, 12, 8, kFused>(a, g);
    case 192:
      return launch_lane<T, 24, 8, kFused>(a, g);
    case 384:
      return launch_lane<T, 24, 16, kFused>(a, g);
    case 768:
      return launch_lane<T, 32, 24, kFused>(a, g);
    case 1536:
      if constexpr (std::is_same<T, float>::value)
        return launch_lane<T, 24, 64, kFused>(a, g);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template int launch_line_r3<float, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r3<float, true>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r3<__nv_bfloat16, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r3<__nv_bfloat16, true>(
    const LineArgs&, const LineGeometry&);

}  // namespace tpufft_strided
