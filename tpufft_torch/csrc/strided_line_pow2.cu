// Instantiations of the strided-axis line form (strided_line.cuh) at
// the power-of-two lengths 8 to 2048;
// line_split there lists each length's four-step.

#include <type_traits>

#include "strided_line.cuh"

namespace tpufft_strided {

template <typename T, bool kFused>
int launch_line_pow2(const LineArgs& a, const LineGeometry& g) {
  switch (g.n1 * g.n2) {
    case 8:
      return launch_lines<T, 8, kFused>(a, g);
    case 16:
      return launch_lines<T, 16, kFused>(a, g);
    case 32:
      return launch_lines<T, 32, kFused>(a, g);
    case 64:
      return launch_lane<T, 8, 8, kFused>(a, g);
    case 128:
      return launch_lane<T, 16, 8, kFused>(a, g);
    case 256:
      return launch_lane<T, 16, 16, kFused>(a, g);
    case 512:
      return launch_lane<T, 32, 16, kFused>(a, g);
    case 1024:
      return launch_lane<T, 32, 32, kFused>(a, g);
    case 2048:
      if constexpr (std::is_same<T, float>::value)
        return launch_lane<T, 32, 64, kFused>(a, g);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template int launch_line_pow2<float, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_pow2<float, true>(
    const LineArgs&, const LineGeometry&);
template int launch_line_pow2<__nv_bfloat16, false>(
    const LineArgs&, const LineGeometry&);
template int launch_line_pow2<__nv_bfloat16, true>(
    const LineArgs&, const LineGeometry&);

}  // namespace tpufft_strided
