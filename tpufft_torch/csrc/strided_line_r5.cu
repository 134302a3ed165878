// Instantiations of the strided-axis line form (strided_line.cuh) at
// the lengths 5 2^a from 10 to 1280;
// line_split there lists each length's four-step.

#include <type_traits>

#include "strided_line.cuh"

namespace tpufft_strided {

template <typename T, bool kFused>
int launch_line_r5(const LineArgs& a, const LineGeometry& g) {
  switch (g.n1 * g.n2) {
    case 10:
      return launch_lines<T, 10, kFused>(a, g);
    case 20:
      return launch_lines<T, 20, kFused>(a, g);
    case 40:
      return launch_lane<T, 10, 4, kFused>(a, g);
    case 80:
      return launch_lane<T, 10, 8, kFused>(a, g);
    case 160:
      return launch_lane<T, 20, 8, kFused>(a, g);
    case 320:
      return launch_lane<T, 20, 16, kFused>(a, g);
    case 640:
      return launch_lane<T, 32, 20, kFused>(a, g);
    case 1280:
      if constexpr (std::is_same<T, float>::value)
        return launch_lane<T, 20, 64, kFused>(a, g);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template int launch_line_r5<float, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r5<float, true>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r5<__nv_bfloat16, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r5<__nv_bfloat16, true>(
    const LineArgs&, const LineGeometry&);

}  // namespace tpufft_strided
