// Instantiations of the strided-axis line form (strided_line.cuh) at
// the lengths 15 2^a from 30 to 1920 (bf16 up to 960);
// line_split there lists each length's four-step.

#include <type_traits>

#include "strided_line.cuh"

namespace tpufft_strided {

template <typename T, bool kFused>
int launch_line_r15(const LineArgs& a, const LineGeometry& g) {
  switch (g.n1 * g.n2) {
    case 30:
      return launch_lines<T, 30, kFused>(a, g);
    case 60:
      return launch_lane<T, 15, 4, kFused>(a, g);
    case 120:
      return launch_lane<T, 15, 8, kFused>(a, g);
    case 240:
      return launch_lane<T, 15, 16, kFused>(a, g);
    case 480:
      return launch_lane<T, 15, 32, kFused>(a, g);
    case 960:
      return launch_lane<T, 15, 64, kFused>(a, g);
    case 1920:
      if constexpr (std::is_same<T, float>::value)
        return launch_lane<T, 30, 64, kFused>(a, g);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template int launch_line_r15<float, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r15<float, true>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r15<__nv_bfloat16, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_r15<__nv_bfloat16, true>(
    const LineArgs&, const LineGeometry&);

}  // namespace tpufft_strided
