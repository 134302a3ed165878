"""The CUDA kernels that one ``tpufft_torch.fft`` call runs, by
torch.profiler, in a process of its own: chip_smoke.py's phase 33 check
that the two-pass split runs exactly two kernels and no copy.

    python3 tools/kernel_profile.py ROWS,N [ROWS,N ...]

For each shape it makes c64 planes on cuda:0 from a seeded generator,
makes one warm call (which uploads the twiddle table), then profiles one
call with the CUDA activity alone (``chip_smoke._cuda_kernels``) and
prints one JSON line:
``{"shape": [ROWS, N], "kernels": [[name, device ms], ...]}``.

It runs in a fresh process because in chip_smoke.py's own process, after
an earlier torch.profiler session there, a profile listed none of the
kernels that the ctypes wrappers launch, where a process's first session
(as here, and as the card test ``test_two_pass_runs_two_kernels`` runs
it) lists both. Imports only torch, numpy and tpufft_torch.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import tpufft_torch  # noqa: E402


def main(argv: list[str]) -> None:
    if not argv or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    for arg in argv:
        rows, n = (int(v) for v in arg.split(","))
        x = tpufft_torch.SplitComplex(
            *chip_smoke._device_planes((rows, n), seed=n % 997))
        tpufft_torch.fft(x)
        kernels = chip_smoke._cuda_kernels(lambda: tpufft_torch.fft(x))
        print(json.dumps({"shape": [rows, n], "kernels": kernels}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
