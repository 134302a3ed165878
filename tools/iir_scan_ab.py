"""The IIR scan's two forms on the card, in turns.

Run from the repository root on a machine with the GPU:

    python3 tools/iir_scan_ab.py [--turns 4]

- ``blocked``: ``tpufft_torch/iir.py`` as it is: ``_section`` lays the
  rows out as 16 rows of 16-sample blocks, runs the recurrence
  sequentially over the rows and scans only the block ends in log depth;
  a cascade stays blocked between sections;
- ``doubling``: the form it replaced, rebuilt here from the same module's
  pieces: ``_affine_scan`` (doubling within 16-sample blocks, recursive
  on the block ends) over the whole signal, the output and final state
  taken from its state planes, each section on (B, n) rows.

On (64, 1048576) f32 it times ``lfilter(*butter(2, 0.2), x, zi=...)``
(one section), ``sosfilt`` and ``sosfiltfilt`` of ``cheby1(8, 0.05, 0.2)``
(4 sections; 8 with the backward pass), each form in turns (doubling,
blocked, blocked, doubling, ...; CUDA events, median of 5 after a warm-up
a turn), with one call's peak device memory above what was allocated
before it, and the largest difference between the two forms' results,
normalized by the result's size. The first line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tpufft_torch  # noqa: E402
from tpufft_torch import iir  # noqa: E402

SHAPE = (64, 1048576)
REPS = 5


def _doubling_section(x, zi, b0, v, M, n):
    """One DF2T section on (B, n) rows by the doubling scan alone."""
    z = iir._affine_scan([x * float(vi) for vi in v],
                         [zi[:, i] for i in range(zi.shape[1])], M)
    prev = torch.cat([zi[:, :1], z[0][:, :-1]], -1)
    return (torch.add(prev, x, alpha=float(b0)),
            torch.stack([zj[:, -1] for zj in z], -1))


@contextlib.contextmanager
def doubling_form():
    saved = (iir._blocked, iir._unblocked, iir._section)
    iir._blocked = lambda x, nb: x
    iir._unblocked = lambda x, n: x
    iir._section = _doubling_section
    try:
        yield
    finally:
        iir._blocked, iir._unblocked, iir._section = saved


def _timed(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (statistics.median(times),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def _run(form, fn):
    if form == "doubling":
        with doubling_form():
            return fn()
    return fn()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("iir_scan_ab: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    g = torch.Generator(device="cuda")
    g.manual_seed(61)
    x = torch.randn(SHAPE, generator=g, device="cuda")
    sos = tpufft_torch.cheby1(8, 0.05, 0.2, output="sos")
    b2, a2 = tpufft_torch.butter(2, 0.2)
    zi = torch.as_tensor(tpufft_torch.lfilter_zi(b2, a2),
                         dtype=torch.float32, device="cuda") * x[:, :1]
    cases = {
        "lfilter butter(2) zi": lambda: iir.lfilter(b2, a2, x, zi=zi)[0],
        "sosfilt cheby1(8)": lambda: iir.sosfilt(sos, x),
        "sosfiltfilt cheby1(8)": lambda: iir.sosfiltfilt(sos, x),
    }
    order = ("doubling", "blocked", "blocked", "doubling")
    for name, fn in cases.items():
        a, b = _run("doubling", fn), _run("blocked", fn)
        diff = ((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
        del a, b
        rows = {"doubling": [], "blocked": []}
        for t in range(args.turns):
            form = order[t % len(order)]
            rows[form].append(_timed(lambda: _run(form, fn)))
            other = "blocked" if form == "doubling" else "doubling"
            rows[other].append(_timed(lambda: _run(other, fn)))
        print(f"{name} {SHAPE} f32: forms differ by {diff:.3e} (normalized)")
        for form, vals in rows.items():
            ms = [t for t, _ in vals]
            print(f"  {form}: ms {' '.join(f'{t:.3f}' for t in ms)} "
                  f"(range {min(ms):.3f}-{max(ms):.3f}), peak GB "
                  f"{max(p for _, p in vals):.3f}")


if __name__ == "__main__":
    main()
