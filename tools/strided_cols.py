"""The strided-axis kernel (K2, K3, K18, K19) on the card, form against form:
the line form with its columns a unit (C) set to 8, 16 and 32, beside the
stage form, on the same planes.

    python3 tools/strided_cols.py [--ns]

It compiles four patched copies of the strided kernel's sources into
``build/strided_cols/<variant>/`` (``strided_phases.build``: one ``nvcc`` a
source, all in parallel): ``stages``, whose launches all run the stage
form, and ``C=8``, ``C=16`` and ``C=32``, whose ``line_geometry`` takes that
C in place of the widest that fits (a launch past the form's bounds at
that C runs the stage form, and its row leaves the C out).

Each row is one launch shape, the median of 20 CUDA-event timings after
two warm-up calls (ms, and GB/s for the planes read once and written
once), each variant first held against the plain version
(``inner_fft.fft_inner_reference`` or ``fft_inner_nd_reference``; 1e-5):
K2 on (100, 640, 480) and on ``rfft2``'s (100, 640, 241), K3 on (10, 128,
16384), K3 with the two-pass twiddle on (16, 1024, 1024), K19 on the fused
(1024, 128, 1, 2 x 256) of P4 and K18 on the fused (10, 128, 128, 2 x 128)
of P3. The launch's own choice (``inner_fft.line_geometry``) is marked *.
``--ns`` adds every length of the line form (n = r 2^a, r in {1, 3, 5},
8 to 2048) on about 268 MB of planes, post 1024, where the choice of
form and C is made. Needs the card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import strided_phases  # noqa: E402
from tpufft_torch import execute  # noqa: E402
from tpufft_torch.kernels import inner_fft, minor_fft  # noqa: E402

# each variant: the C its launches take, None for the stage form
FORMS = {"stages": None, "C=8": 8, "C=16": 16, "C=32": 32}


def median_ms(fn, reps: int = 20) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _norm_err(got, ref) -> float:
    scale = max(1.0, max(r.abs().max().item() for r in ref))
    return max((g.float() - r.float()).abs().max().item()
               for g, r in zip(got, ref)) / scale


def planes_call(lib, xr, xi, n, post, tw=None, tw_l=0):
    """The strided kernel of ``lib`` on contiguous planes viewed (pre, n,
    post); returns (yr, yi)."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rad = minor_fft.radices(n)
    arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    table = minor_fft._device_twiddles(n, False, xr.device)
    err = lib.tpufft_strided_fft(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        table.data_ptr(), xr.numel() // (n * post), n, post, arr, len(rad),
        None if tw is None else tw.data_ptr(),
        0 if tw is None else tw.shape[1], tw_l, 0, 1.0,
        int(xr.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return yr, yi


def fused_call(lib, st, n, M, L):
    out = torch.empty_like(st)
    rad = minor_fft.radices(n)
    arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    table = minor_fft._device_twiddles(n, False, st.device)
    err = lib.tpufft_strided_fft_fused(
        st.data_ptr(), out.data_ptr(), table.data_ptr(),
        st.numel() // (n * M * 2 * L), n, M, L, arr, len(rad), 0, 1.0,
        int(st.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return out


def row(libs, name, n, post, nbytes, run, plain) -> None:
    """Time ``run(lib)`` with each variant's library on this shape,
    leaving out a C whose launch would run the stage form."""
    ref = plain()
    auto = inner_fft.line_geometry(n, post, torch.float32)
    parts = []
    for form, cols in FORMS.items():
        lib = libs[form]
        if strided_phases.columns(lib, n, post) != cols:
            continue
        err = _norm_err(run(lib), ref)
        if err >= 1e-5:
            raise RuntimeError(f"{name} {form}: vs plain {err:.3e}")
        t = median_ms(lambda: run(lib))
        mark = "*" if (auto or {}).get("cols") == cols else ""
        parts.append(f"{form}{mark} {t:.4f} ({nbytes / t / 1e6:.0f} GB/s)")
    print(f"{name}: " + ", ".join(parts), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("strided_cols: needs the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    head = strided_phases.header()
    libs = {form: lib for form, (lib, _) in strided_phases.build(
        {form: strided_phases.with_cols(head, c) if c
         else strided_phases.stages_only(head) for form, c in FORMS.items()},
        "build/strided_cols", stub_r3=False).items()}
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    kw = dict(inverse=False, scale=1.0)

    def planes(shape):
        return (torch.randn(shape, generator=g, device="cuda"),
                torch.randn(shape, generator=g, device="cuda"))

    for name, (pre, n, post) in (("K2", (100, 640, 480)),
                                 ("K2 rfft2", (100, 640, 241)),
                                 ("K3", (10, 128, 16384))):
        xr, xi = planes((pre, n, post))
        row(libs, f"{name} {(pre, n, post)}", n, post, 16 * xr.numel(),
            lambda lib: planes_call(lib, xr, xi, n, post),
            lambda: inner_fft.fft_inner_reference(xr, xi, **kw))
        del xr, xi
    a, b = execute._split_large(1048576)
    xr, xi = planes((16 * a, b, 1))
    tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
    row(libs, f"K3 + twiddle {(16, a, b)}", a, b, 16 * xr.numel(),
        lambda lib: planes_call(lib, xr, xi, a, b, tw, 1),
        lambda: inner_fft.fft_inner_nd_reference(xr, xi, n=a, twiddle=tw,
                                                 **kw))
    del xr, xi
    for name, (pre, n, M, L) in (("K19 P4", (1024, 128, 1, 256)),
                                 ("K18 P3", (10, 128, 128, 128))):
        st = torch.randn(pre, n, M, 2 * L, generator=g, device="cuda")
        h = st.shape[-1] // 2

        def halves(out):
            return out[..., :h], out[..., h:]

        ref = (st[..., :h].contiguous(), st[..., h:].contiguous())
        view = (pre, n, M * L)
        row(libs, f"{name} {(pre, n, M, 2 * L)}", n, M * L, 8 * st.numel(),
            lambda lib: halves(fused_call(lib, st, n, M, L)),
            lambda: tuple(y.reshape(st[..., :h].shape) for y in
                          inner_fft.fft_inner_reference(
                              ref[0].reshape(view), ref[1].reshape(view),
                              **kw)))
        del st, ref
    if "--ns" in sys.argv[1:]:
        for n in sorted({r << a for r in (1, 3, 5) for a in range(12)
                         if 8 <= r << a <= 2048}):
            post = 1024
            pre = max(1, 2 ** 24 // (n * post))
            xr, xi = planes((pre, n, post))
            row(libs, f"n={n} {(pre, n, post)}", n, post, 16 * xr.numel(),
                lambda lib: planes_call(lib, xr, xi, n, post),
                lambda: inner_fft.fft_inner_reference(xr, xi, **kw))
            del xr, xi


if __name__ == "__main__":
    main()
