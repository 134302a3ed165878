"""Time the split-plane kernels K1 (minor axis, (100000, 1024) c64) and K5
(cube, (100, 64, 64, 64) c64) of two checkouts of tpufft_torch in turns on
one card: old, new, new, old.

    python3 tools/split_plane_ab.py OLD_ROOT [NEW_ROOT]

Each turn is a fresh process that imports that checkout's tpufft_torch
(building its library on first use) and prints the median of 20 CUDA-event
timings after two warm-up calls. NEW_ROOT defaults to this checkout. Needs
the card.
"""

from __future__ import annotations

import os
import subprocess
import sys

TIMER = r"""
import statistics, torch
from tpufft_torch.kernels import cube_fft, minor_fft

def median_ms(fn, reps=20):
    fn(); fn(); torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

g = torch.Generator(device="cuda"); g.manual_seed(1)
xr = torch.randn(100000, 1024, generator=g, device="cuda")
xi = torch.randn(100000, 1024, generator=g, device="cuda")
k1 = median_ms(lambda: minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0))
cr = torch.randn(100, 64, 64, 64, generator=g, device="cuda")
ci = torch.randn(100, 64, 64, 64, generator=g, device="cuda")
k5 = median_ms(lambda: cube_fft.fft_cube(cr, ci, inverse=False, scale=1.0))
print(f"K1 {k1:.4f} ms K5 {k5:.4f} ms")
"""


def main() -> int:
    old = os.path.abspath(sys.argv[1])
    new = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else
                          os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", TIMER], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
        print(f"{label} ({root}): {out.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
