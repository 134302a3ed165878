// The Stockham stages of fft_stages.cuh run by teams of warps: each team
// owns whole lines of a shared tile and synchronises only its own threads
// (__syncwarp for one warp, a named barrier for several, __syncthreads for
// the whole block). Lines are rows (consecutive threads on consecutive
// butterflies of a line) or columns of a row-major tile (consecutive
// threads on one butterfly of consecutive lines), so both touch
// consecutive tile elements. A pass's first stage may read its inputs
// through a loader instead of the tile, and a column pass's last stage may
// hand its outputs to a storer instead, so that device memory is read and
// written from registers. Used by the trailing-pair kernel (pair_fft.cu:
// rows, then columns).

#pragma once

#include "minor_fft.cuh"

namespace tpufft_team {

using namespace tpufft_fft;

constexpr int kMaxTeams = 15;   // named barriers 1..15 (0 is the block's)

// A team: `size` threads (whole warps) of the block that run the stages of
// their lines together. bar: -1 for one warp, 0 for the whole block,
// otherwise the named barrier 1 + index.
struct Team {
  int rank, size, index, bar;
  __device__ __forceinline__ explicit Team(int warps) {
    size = warps * 32;
    index = threadIdx.x / size;
    rank = threadIdx.x - index * size;
    bar = warps * 32 == (int)blockDim.x ? 0 : warps == 1 ? -1 : 1 + index;
  }
  __device__ __forceinline__ void sync() const {
    if (bar < 0)
      __syncwarp();
    else if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(size) : "memory");
  }
};

// The lines a team owns in one pass: lines l0 .. l0 + cnt - 1 of length n.
// Rows (kCols false): row r = slice * n1 + k1 is tile[r n2 + i]; columns:
// column c = slice * n2 + k2 is tile[slice area + i n2 + k2].
template <bool kCols>
struct Lines {
  int l0, cnt, n, n2, area;
  Div by_n2;
  __device__ __forceinline__ Lines(int l0_, int cnt_, int n_, int n2_,
                                   int area_)
      : l0(l0_), cnt(cnt_), n(n_), n2(n2_), area(area_), by_n2(n2_) {}
  // tile index of element 0 of the team's line l, and the step to element 1
  __device__ __forceinline__ int base(int l) const {
    const int g = l0 + l;
    if (!kCols) return g * n2;
    const int slice = by_n2(g);
    return slice * area + (g - slice * n2);
  }
  __device__ __forceinline__ int step() const { return kCols ? n2 : 1; }
  // item `it` of a stage with `per` items a line -> (line, item in line):
  // rows keep a line's items on consecutive threads, columns put
  // consecutive lines there
  __device__ __forceinline__ void split(int it, const Div& by, int per,
                                        int& l, int& j) const {
    if (kCols) {
      j = by(it);
      l = it - j * cnt;
    } else {
      l = by(it);
      j = it - l * per;
    }
  }
};

// One radix-R (2, 4, 8) stage over a team's lines (the stage math of
// fft_stages.cuh:stage_pow2). kIn: the inputs come from device memory as
// load(line, i); kOut: the outputs go to device memory as
// store(line, i, v). Otherwise both are the tile.
template <int R, int kPer, bool kCols, bool kIn, bool kOut, class Load,
          class Store>
__device__ __forceinline__ void team_stage(float2* buf,
                                           const float2* __restrict__ tw,
                                           const Lines<kCols>& ln, int s,
                                           bool inv, const Team& tm,
                                           const Load& load,
                                           const Store& store) {
  constexpr int K = kPer / R;
  const int m = ln.n / (R * s), per = ln.n / R;
  const int items = ln.cnt * per;
  const Div by_s(s), by_x(kCols ? ln.cnt : per);
  float2 v[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = tm.rank + k * tm.size;
    if (it < items) {
      int l, bf;
      ln.split(it, by_x, per, l, bf);
      const int p = by_s(bf);
      const int at = ln.base(l);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = bf + b * m * s;
        v[k][b] = kIn ? load(ln.l0 + l, i) : buf[pad(at + i * ln.step())];
      }
      butterfly<R>(v[k], inv);
#pragma unroll
      for (int j = 1; j < R; ++j) v[k][j] = cmul(v[k][j], __ldg(&tw[j * p * s]));
    }
  }
  if (!kIn && !kOut) tm.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = tm.rank + k * tm.size;
    if (it < items) {
      int l, bf;
      ln.split(it, by_x, per, l, bf);
      const int p = by_s(bf), q = bf - p * s;
      const int dst = p * R * s + q;
      const int at = ln.base(l);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (kOut)
          store(ln.l0 + l, dst + j * s, v[k][j]);
        else
          buf[pad(at + (dst + j * s) * ln.step())] = v[k][j];
      }
    }
  }
  if (!kOut) tm.sync();
}

// One stage of an odd radix r over a team's lines, from the tile (the
// stage math and item split of fft_stages.cuh:stage_odd); kOut as above.
template <int kPer, bool kCols, bool kOut, class Store>
__device__ __forceinline__ void team_stage_odd(float2* buf,
                                               const float2* __restrict__ tw,
                                               const Lines<kCols>& ln, int r,
                                               int s, const Team& tm,
                                               const Store& store) {
  constexpr int K = (2 * kPer + 2) / 3;
  const int h = (r - 1) / 2;
  const int stride = ln.n / r;  // distance between the r inputs
  const int groups = ln.cnt * stride;
  const int items = groups * (h + 1);
  const Div by_g(groups), by_s(s), by_x(kCols ? ln.cnt : stride);
  float2 v0[K], v1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = tm.rank + k * tm.size;
    if (it < items) {
      const int jj = by_g(it), g = it - jj * groups;
      int l, rem;
      ln.split(g, by_x, stride, l, rem);
      const int p = by_s(rem);
      const int at0 = ln.base(l), st = ln.step();
      const auto at = [&](int b) {
        return buf[pad(at0 + (rem + b * stride) * st)];
      };
      const float2 x0 = at(0);
      if (jj == 0) {
        v0[k] = odd_sum(at, x0, r);
      } else {
        float2 o1, o2;
        odd_pair(at, x0, tw, r, stride, jj, o1, o2);
        v0[k] = cmul(o1, __ldg(&tw[jj * p * s]));
        v1[k] = cmul(o2, __ldg(&tw[(r - jj) * p * s]));
      }
    }
  }
  if (!kOut) tm.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int it = tm.rank + k * tm.size;
    if (it < items) {
      const int jj = by_g(it), g = it - jj * groups;
      int l, rem;
      ln.split(g, by_x, stride, l, rem);
      const int p = by_s(rem), q = rem - p * s;
      const int dst = p * r * s + q;
      if (kOut) {
        store(ln.l0 + l, dst + jj * s, v0[k]);
        if (jj) store(ln.l0 + l, dst + (r - jj) * s, v1[k]);
      } else {
        const int at0 = ln.base(l), st = ln.step();
        buf[pad(at0 + (dst + jj * s) * st)] = v0[k];
        if (jj) buf[pad(at0 + (dst + (r - jj) * s) * st)] = v1[k];
      }
    }
  }
  if (!kOut) tm.sync();
}

// A radix-r stage, r in {2, 4, 8}.
template <int kPer, bool kCols, bool kIn, bool kOut, class Load, class Store>
__device__ __forceinline__ void pow2_stage(int r, float2* buf,
                                           const float2* __restrict__ tw,
                                           const Lines<kCols>& ln, int s,
                                           bool inv, const Team& tm,
                                           const Load& load,
                                           const Store& store) {
  if (r == 8)
    team_stage<8, kPer, kCols, kIn, kOut>(buf, tw, ln, s, inv, tm, load,
                                          store);
  else if (r == 4)
    team_stage<4, kPer, kCols, kIn, kOut>(buf, tw, ln, s, inv, tm, load,
                                          store);
  else
    team_stage<2, kPer, kCols, kIn, kOut>(buf, tw, ln, s, inv, tm, load,
                                          store);
}

// Every stage of `plan` over a team's lines. Rows (kCols false): the first
// stage reads device memory through load, unless the caller has copied the
// lines into the tile (from_tile, for an odd first radix); the pass ends
// synchronized. Columns: the last stage writes device memory through
// store. kOdd false: every radix is 2, 4 or 8, and the odd stages are not
// compiled (their registers then cost the power-of-two stages nothing).
template <int kPer, bool kOdd, bool kCols, class Load, class Store>
__device__ void team_pass(float2* buf, const float2* __restrict__ tw,
                          const Radices& plan, const Lines<kCols>& ln,
                          bool inv, bool from_tile, const Team& tm,
                          const Load& load, const Store& store) {
  int s = 1;
  for (int t = 0; t < plan.count; ++t) {
    const int r = plan.r[t];
    const bool pow2 = !kOdd || r == 8 || r == 4 || r == 2;
    if constexpr (kCols) {
      const bool out = t == plan.count - 1;
      if (pow2 && out)
        pow2_stage<kPer, true, false, true>(r, buf, tw, ln, s, inv, tm, load,
                                            store);
      else if (pow2)
        pow2_stage<kPer, true, false, false>(r, buf, tw, ln, s, inv, tm,
                                             load, store);
      else if constexpr (kOdd) {
        if (out)
          team_stage_odd<kPer, true, true>(buf, tw, ln, r, s, tm, store);
        else
          team_stage_odd<kPer, true, false>(buf, tw, ln, r, s, tm, store);
      }
    } else {
      if (pow2 && t == 0 && !from_tile)
        pow2_stage<kPer, false, true, false>(r, buf, tw, ln, s, inv, tm,
                                             load, store);
      else if (pow2)
        pow2_stage<kPer, false, false, false>(r, buf, tw, ln, s, inv, tm,
                                              load, store);
      else if constexpr (kOdd)
        team_stage_odd<kPer, false, false>(buf, tw, ln, r, s, tm, store);
    }
    s *= r;
  }
}

// The team's share of a pass's lines: contiguous runs of ceil(lines /
// teams).
__device__ __forceinline__ void share(const Team& tm, int lines, int& l0,
                                      int& cnt) {
  const int teams = blockDim.x / tm.size;
  const int per = (lines + teams - 1) / teams;
  l0 = tm.index * per;
  cnt = min(per, lines - l0);
}

// Host: warps a team of a pass takes, for W warps and `lines` lines of
// length len: the fewest (1, a divisor of W with at most kMaxTeams teams,
// or W) whose share, ceil(lines / teams) lines, fits its threads' kPer
// values and, for columns (want_runs), holds 32 lines where the pass has
// them, so that a warp stores 32 consecutive k2.
inline int team_warps(int W, int lines, int len, int per, bool want_runs) {
  for (int g = 1; g < W; ++g) {
    if (W % g || (g > 1 && W / g > kMaxTeams)) continue;
    const int teams = W / g;
    const int share = (lines + teams - 1) / teams;
    if ((long long)share * len > (long long)g * 32 * per) continue;
    if (want_runs && share < (lines < 32 ? lines : 32)) continue;
    return g;
  }
  return W;
}

}  // namespace tpufft_team
