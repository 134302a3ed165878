"""The mid-pair route choice on the card: K6 (one pass over two adjacent
middle axes) against the two strided passes it replaces (K3 on axis 1, then
K2 on axis 2), at pairs across K6's forms and block shares.

Run from the repository root on a machine with the GPU:

    python3 tools/mid_route.py [--turns N] [--elements E]

For each pair (n1, n2) of PAIRS and each L of LS, (pre, n1, n2, L) c64
planes of about ``--elements`` elements (pre rounded, at least 1) are made
on the card; K6 through its wrapper (``mid_pair_fft.fft_mid_pair``, the
form the launch picks) and K3 + K2 (``chip_smoke._axes_1_2``) are held
against each other (f32 1e-5) and timed by CUDA events in turns (K6, K3 +
K2, K3 + K2, K6, ``--turns`` times; each a median of 20 after two warm-up
calls). Each line gives K6's form, cluster size and elements a block (the
share), both medians, their ratio, the route ``execute.mid_pair_ok`` takes
and whether it is the faster one. Every line names the card and its power
limit; the last line is a JSON object of the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpufft_torch import _build, execute  # noqa: E402
from tpufft_torch.api import PlanConfig  # noqa: E402
from tpufft_torch.kernels import mid_pair_fft  # noqa: E402

# the generic-radix form from small to large shares, 60 x 120 (four blocks
# of 14400) beside 120 x 60 (eight of 7200), the 7 family (whose strided
# passes run the stage form) and two power-of-two pairs of the line form
PAIRS = ((48, 48), (80, 80), (48, 160), (64, 120), (96, 96), (60, 120),
         (120, 60), (128, 96), (80, 160), (240, 60), (160, 96), (192, 96),
         (160, 128), (256, 96), (160, 160), (120, 120), (192, 160),
         (256, 128), (112, 112), (224, 56), (56, 224), (64, 128),
         (128, 128))
LS = (16, 48, 160)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--elements", type=int, default=1 << 25)
    args = ap.parse_args()
    _build.load()
    card = chip_smoke._smi("name,power.limit")
    config = PlanConfig()
    kw = dict(inverse=False, scale=1.0)
    result, wrong = {}, 0
    for n1, n2 in PAIRS:
        for L in LS:
            pre = max(1, round(args.elements / (n1 * n2 * L)))
            shape = (pre, n1, n2, L)
            xr, xi = chip_smoke._device_planes(shape, seed=n1 + n2 + L)

            def k6():
                return mid_pair_fft.fft_mid_pair(xr, xi, **kw)

            def two():
                return chip_smoke._axes_1_2(xr, xi)

            err = chip_smoke.pair_err(k6(), two())
            chip_smoke.check(err < chip_smoke.F32_TOL,
                             f"{shape}: K6 vs K3 + K2 {err:.3e}")
            times = {"k6": [], "two": []}
            for _ in range(args.turns):
                for who, fn in (("k6", k6), ("two", two), ("two", two),
                                ("k6", k6)):
                    times[who].append(chip_smoke._time_ms(fn))
            med = {k: statistics.median(v) for k, v in times.items()}
            c = mid_pair_fft.cluster_size(n1, n2)
            share = n1 // c * n2 * mid_pair_fft.lanes(n1, n2)
            route = ("k6" if execute.mid_pair_ok(n1, n2, L, torch.float32,
                                                 config) else "two")
            faster = min(med, key=med.get)
            wrong += route != faster
            print(f"{card}: {shape} {mid_pair_fft.form(n1, n2, L)} form, "
                  f"clusters of {c}, share {share}: K6 {med['k6']:.4f} "
                  f"({min(times['k6']):.4f}-{max(times['k6']):.4f}), K3 + K2 "
                  f"{med['two']:.4f} ({min(times['two']):.4f}-"
                  f"{max(times['two']):.4f}) ms, K6 / two "
                  f"{med['k6'] / med['two']:.3f}; route {route}"
                  f"{'' if route == faster else ' (the slower)'}; vs "
                  f"{err:.3e}", flush=True)
            result[str(shape)] = dict(med, share=share, route=route)
            del xr, xi
    print(f"{card}: the route takes the slower pass at {wrong} of "
          f"{len(result)} shapes")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
