"""Time kernels of two checkouts of tpufft_torch in turns on one card: old,
new, new, old.

    python3 tools/split_plane_ab.py [--rounds R] [--only ROWS] OLD_ROOT [NEW_ROOT]

The rows, each the median of 20 CUDA-event timings after two warm-up
calls, in ms:

- the minor-axis kernel: K1 at (100000, 1024) c64 (the line form's
  four-step at n = 1024, the main path) and ``torch.fft.fft`` of it
  (``cuFFT_1024``), K1 at (1000000, 64), (50000, 2048) and (100000, 4096)
  (the line form's one-warp rows, its lane-pair four-step at 2048, and at
  4096 the lane-pair four-step or, since, the three-factor form), each
  beside ``torch.fft.fft`` of it (``cuFFT``), K20 on the (131072, 2 x 256)
  fused array (P4's minor axis) beside ``torch.fft.fft`` of its
  (131072, 256) halves (``cuFFT_256``), K1 at (1000000, 93), (64000,
  480) (``fft2``'s minor axis), (19200, 1080) and (3840, 2160) (the
  survey's ``fft2`` minor axes), (10000, 8320) (Bluestein's), (10000,
  8192) and (5000, 16384) (each on the form the checkout gives it: above
  4096 the stage form before the three-factor form); K9 (1000000, 93 ->
  128) and at
  ``czt``'s (100000, 1024 -> 2048) and ``envelope``'s (10000, 2047 ->
  4096) shapes (``K9_2048``, ``K9_4096``), each on the form the checkout
  gives it;
- the paths above K1: the 1-D C2C ``plan_fft`` of (100000, 1024)
  ``SplitComplex`` planes (``c2c``), the two-pass ``fft`` of (16, 1048576)
  (``two_pass``), Bluestein ``fft`` of (10000, 4099) (``bluestein``) and
  ``czt`` of real (100000, 1024) rows to 1024 points on
  ``chip_smoke.py``'s arc (K9 + K1), ``fft(n="fast-aligned")`` of
  (1000000, 93) ``SplitComplex`` planes (``fast_aligned``, K9) and
  ``envelope`` of real (10000, 4096) rows (K7 + K9 + K8);
- K5 (cube, (100, 64, 64, 64) c64),
  K16 (the cube on the fused (100, 64, 64, 2 x 64) array of the same
  data), K7 (real minor axis, (100000, 1024) f32) and K6 (middle pair,
  (32, 64, 128, 128) c64);
- K7 at the ends of its line form, (400000, 256) and (12500, 8192) f32,
  each beside ``torch.fft.rfft`` of it (``rfft``), and at (1000000, 93)
  on the form the tree gives it (the stage form, or the mixed-radix line
  form where the tree has it); K8 (irfft, (100000, 513) planes to (100000,
  1024)), and at the ends of its line form, (400000, 129) planes to 256
  and (12500, 4097) to 8192, each beside ``torch.fft.irfft`` of it
  (``irfft``), and at (1000000, 47) planes to 93 on the form the tree
  gives it; the ``rfft`` path of real (100000, 1024)
  rows beside ``torch.fft.rfft`` (``torch_rfft_1024``), the ``irfft``
  path of c64 (100000, 513) rows beside ``torch.fft.irfft``
  (``torch_irfft_1024``), and the ``fht`` path (``fht(x, 0.05, 0.5)``,
  K7 + K8) of real (100000, 1024) rows;
- K13 (``stft_frames``) on (64, 1048832) f32 at nperseg 256, hop 128 (the
  ``stft`` path's shape: 1048576 samples extended by 128 a side), beside
  ``torch.stft(center=False)`` of the same frames;
- K4 (``fft_pair``) on (1280, 128, 128) c64, K4 with ``n2_in`` on
  (10000, 64, 93) zero-padded to (10000, 64, 128), K4's packed form on
  (200000, 8, 93) (five slices a block), and K17 (``fft_pair_fused``) on
  the (1280, 128, 2 x 128) fused array, beside ``torch.fft.fft2``;
- the strided kernel: K2 (``fft_inner``) on (100, 640, 480) (``fft2``'s
  axis 1) and on ``rfft2``'s (100, 640, 241), each beside ``torch.fft.fft``
  of it along dim 1 (``cuFFT``), on T1's (1, 93, 1000000) and on the
  survey's (10, 1920, 1080) and (1, 3840, 2160) (each on the form the
  checkout gives it: at 3840 the stage form before the cluster form); K3
  (``fft_inner_nd``, n = 128) on (1280, 128, 128) and with the two-pass
  twiddle on (16384, 1024, 1) (``K3_tw``); K18 (``fft_inner_fused``) on P3's fused (10, 128, 128, 2 x
  128) and K19 on P4's (1024, 128, 1, 2 x 256); the ``fft2`` path of
  (100, 640, 480) ``SplitComplex`` planes (K2 + K1);
- the lane-fused plans P3 (10, 128, 128, 128) and P4 (16, 64, 128, 256)
  over axes 1-3;
- the dense kernels at their paths' shapes: K11 (``dense_mm_real``,
  (100000, 512) x (512, 512) f32), K12 (``r2r_minor``, (100000, 1024) x the
  (1024, 1024) DCT-II table), K10 (``dense_mm_complex``, (100000, 512) x
  (512, 512) c64 planes), and K14 and K15 (``welch_accum``, welch and
  csd) at the spectral paths' shapes, (64, 1048576) signals at nperseg
  256, hop 128, and the ``welch``, ``csd``, ``coherence`` and (with
  ``K14``) ``istft`` paths of the same signals (``spectral``); K14 runs
  through whichever API the checkout has (``istft_frames`` with the
  window and c, else ``istft_ola`` with the matrix of the same
  function);
- the paths above K10, K11 and K12, as ``chip_smoke.py`` drives them:
  ``filter_real`` (a low-pass ``plan_filter(512)``, bins |k| <= 64, on
  real (100000, 512) rows), ``filter_complex`` (the same plan on c64
  (100000, 512) rows, K10), ``hilbert`` (real (100000, 512) rows, K10),
  ``dct`` (100000, 1024) and ``dst4`` (``dst(type=4)`` on (100000, 93)).

Each turn is a fresh process that imports that checkout's tpufft_torch
(building its library on first use). K13's and K15's arguments changed
between checkouts (a host matrix before, the window, nfft, the detrend
kind and for K13 c now): the timer passes whichever the checkout's
``stft_frames`` or ``welch_accum`` takes, for the same function (hann
window; K13 scale 1/sum(window), no detrend; K15 constant detrend).
NEW_ROOT defaults to this checkout. ``--rounds R`` runs the four turns R
times (old, new, new, old, old, new, ...); ``--only`` takes a comma-separated
list of the rows above (K1, K1_64, K1_2048, K1_4096, K20, K1_93, K1_480,
K1_1080, K1_2160, K1_8320, K1_8192, K1_16384,
K9, K9_2048, K9_4096, c2c, two_pass, bluestein, czt, fast_aligned,
envelope, K5, K16, K7, K6, K7_256, K7_8192, K7_93,
K8, K8_256, K8_8192, K8_93, irfft, rfft, fht, K13, K4, K4_n2_in, K4_packed,
K17, K2, K2_241, K2_93, K2_1920, K2_3840, K3, K3_tw, K18, K19, fft2, P3,
P4, K11,
K12, K10,
K14, K15, spectral, filter_real, filter_complex, hilbert, dct, dst4)
and times those alone. Needs the card.
"""

from __future__ import annotations

import os
import subprocess
import sys

TIMER = r"""
import inspect, statistics, torch
import numpy as np
from tpufft_torch import SplitComplex, plan_fft, spectral
from tpufft_torch.kernels import (cube_fft, fused_fft, inner_fft,
                                  mid_pair_fft, minor_fft, pair_fft, real_fft,
                                  stft_mm)

def median_ms(fn, reps=20):
    fn(); fn(); torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

import os
ONLY = os.environ.get("AB_ONLY")
def want(*names):
    return not ONLY or any(n in ONLY.split(",") for n in names)

rows = {}
kw = dict(inverse=False, scale=1.0)
g = torch.Generator(device="cuda"); g.manual_seed(1)
for name, shape in (("K1_64", (1000000, 64)), ("K1_4096", (100000, 4096)),
                    ("K1_2048", (50000, 2048)),
                    ("K1_93", (1000000, 93)), ("K1_480", (64000, 480)),
                    ("K1_1080", (19200, 1080)), ("K1_2160", (3840, 2160)),
                    ("K1_8320", (10000, 8320)), ("K1_8192", (10000, 8192)),
                    ("K1_16384", (5000, 16384))):
    if want(name):
        xr = torch.randn(*shape, generator=g, device="cuda")
        xi = torch.randn(*shape, generator=g, device="cuda")
        rows[name] = median_ms(lambda: minor_fft.fft_minor(xr, xi, **kw))
        if name in ("K1_64", "K1_2048", "K1_4096"):
            c = torch.complex(xr, xi)
            rows[name + " cuFFT"] = median_ms(lambda: torch.fft.fft(c))
            del c
        del xr, xi
for name, rows_, n_in, n in (("K9", 1000000, 93, 128),
                              ("K9_2048", 100000, 1024, 2048),
                              ("K9_4096", 10000, 2047, 4096)):
    if want(name):
        xr = torch.randn(rows_, n_in, generator=g, device="cuda")
        xi = torch.randn(rows_, n_in, generator=g, device="cuda")
        rows[name] = median_ms(lambda: minor_fft.fft_minor_padded(
            xr, xi, n=n, **kw))
        del xr, xi
if want("K20"):
    st = torch.randn(131072, 512, generator=g, device="cuda")
    rows["K20"] = median_ms(lambda: fused_fft.fft_minor_fused(st, **kw))
    c = torch.complex(st[:, :256], st[:, 256:])
    rows["cuFFT_256"] = median_ms(lambda: torch.fft.fft(c, dim=-1))
    del st, c
for name, shape in (("c2c", (100000, 1024)), ("two_pass", (16, 1048576)),
                    ("bluestein", (10000, 4099))):
    if want(name):
        import tpufft_torch
        x = SplitComplex(torch.randn(*shape, generator=g, device="cuda"),
                         torch.randn(*shape, generator=g, device="cuda"))
        if name == "c2c":
            plan = plan_fft(shape, torch.complex64, axes=(-1,))
            rows[name] = median_ms(lambda: plan(x))
        else:
            rows[name] = median_ms(lambda: tpufft_torch.fft(x))
        del x
if want("czt"):
    import tpufft_torch
    x = torch.randn(100000, 1024, generator=g, device="cuda")  # real rows
    zw = np.exp(-2j * np.pi * 0.25 / 1024)
    za = np.exp(2j * np.pi * 0.1)
    rows["czt"] = median_ms(lambda: tpufft_torch.czt(x, 1024, zw, za))
    del x
if want("fast_aligned"):
    import tpufft_torch
    x = SplitComplex(torch.randn(1000000, 93, generator=g, device="cuda"),
                     torch.randn(1000000, 93, generator=g, device="cuda"))
    rows["fast_aligned"] = median_ms(
        lambda: tpufft_torch.fft(x, n="fast-aligned"))
    del x
if want("envelope"):
    import tpufft_torch
    x = torch.randn(10000, 4096, generator=g, device="cuda")  # real rows
    rows["envelope"] = median_ms(lambda: tpufft_torch.envelope(x))
    del x
if want("K1", "K5", "K16", "K7", "K6"):
    xr = torch.randn(100000, 1024, generator=g, device="cuda")
    xi = torch.randn(100000, 1024, generator=g, device="cuda")
    rows["K1"] = median_ms(lambda: minor_fft.fft_minor(xr, xi, **kw))
    c = torch.complex(xr, xi)
    rows["cuFFT_1024"] = median_ms(lambda: torch.fft.fft(c, dim=-1))
    del c
    cr = torch.randn(100, 64, 64, 64, generator=g, device="cuda")
    ci = torch.randn(100, 64, 64, 64, generator=g, device="cuda")
    rows["K5"] = median_ms(lambda: cube_fft.fft_cube(cr, ci, **kw))
    cst = torch.cat([cr, ci], -1)
    rows["K16"] = median_ms(lambda: fused_fft.fft_cube_fused(cst, **kw))
    rows["K7"] = median_ms(lambda: real_fft.rfft_minor(xr, scale=1.0))
    del xr, xi, cr, ci, cst
    mr = torch.randn(32, 64, 128, 128, generator=g, device="cuda")
    mi = torch.randn(32, 64, 128, 128, generator=g, device="cuda")
    rows["K6"] = median_ms(lambda: mid_pair_fft.fft_mid_pair(mr, mi, **kw))
    del mr, mi
for name, shape in (("K7_256", (400000, 256)), ("K7_8192", (12500, 8192)),
                    ("K7_93", (1000000, 93))):
    if want(name):
        x = torch.randn(*shape, generator=g, device="cuda")
        rows[name] = median_ms(lambda: real_fft.rfft_minor(x, scale=1.0))
        if name != "K7_93":
            rows[name + " rfft"] = median_ms(lambda: torch.fft.rfft(x))
        del x
if want("K8", "rfft", "fht"):
    import tpufft_torch
    x = torch.randn(100000, 1024, generator=g, device="cuda")
    if want("rfft"):
        rows["rfft"] = median_ms(lambda: tpufft_torch.rfft(x))
        rows["torch_rfft_1024"] = median_ms(lambda: torch.fft.rfft(x))
    if want("fht"):
        rows["fht"] = median_ms(lambda: tpufft_torch.fht(x, 0.05, 0.5))
    if want("K8"):
        hr = torch.randn(100000, 513, generator=g, device="cuda")
        hi = torch.randn(100000, 513, generator=g, device="cuda")
        rows["K8"] = median_ms(lambda: real_fft.irfft_minor(
            hr, hi, n=1024, scale=1.0 / 1024))
        del hr, hi
    del x
for name, shape in (("K8_256", (400000, 256)), ("K8_8192", (12500, 8192)),
                    ("K8_93", (1000000, 93))):
    if want(name):
        n = shape[1]
        hr = torch.randn(shape[0], n // 2 + 1, generator=g, device="cuda")
        hi = torch.randn(shape[0], n // 2 + 1, generator=g, device="cuda")
        rows[name] = median_ms(lambda: real_fft.irfft_minor(
            hr, hi, n=n, scale=1.0 / n))
        if name != "K8_93":
            hc = torch.complex(hr, hi)
            rows[name + " irfft"] = median_ms(lambda: torch.fft.irfft(hc, n=n))
            del hc
        del hr, hi
if want("irfft"):
    import tpufft_torch
    xc = torch.complex(torch.randn(100000, 513, generator=g, device="cuda"),
                       torch.randn(100000, 513, generator=g, device="cuda"))
    rows["irfft"] = median_ms(lambda: tpufft_torch.irfft(xc, n=1024))
    rows["torch_irfft_1024"] = median_ms(lambda: torch.fft.irfft(xc, n=1024))
    del xc

x = torch.randn(64, 1048832, generator=g, device="cuda")
nperseg, hop = 256, 128
nseg = 1 + (x.shape[1] - nperseg) // hop
win = np.hanning(nperseg + 1)[:-1]   # scipy's periodic hann
fold = 1.0 / win.sum()
if "win" in inspect.signature(stft_mm.stft_frames).parameters:
    w = torch.tensor(win, dtype=torch.float32, device="cuda")
    c_r = torch.full((nperseg // 2 + 1,), fold, device="cuda")
    c_i = torch.zeros_like(c_r)
    k13 = lambda: stft_mm.stft_frames(x, w, c_r, c_i, nperseg, False, hop,
                                      nseg)
else:
    mr, mi = spectral._tables("stft", win, nperseg, nperseg, (None, fold),
                              torch.device("cuda"))
    k13 = lambda: stft_mm.stft_frames(x, mr, mi, hop)
if want("K13"):
    rows["K13"] = median_ms(k13)
    w32 = torch.tensor(win, dtype=torch.float32, device="cuda")
    rows["torch.stft"] = median_ms(lambda: torch.stft(
        x, nperseg, hop, window=w32, center=False, return_complex=True))
del x

for name, shape, n2 in (("K4", (1280, 128, 128), 128),
                        ("K4_n2_in", (10000, 64, 93), 128),
                        ("K4_packed", (200000, 8, 93), 93)):
    if not want(name, "K17" if name == "K4" else name):
        continue
    pr = torch.randn(*shape, generator=g, device="cuda")
    pi = torch.randn(*shape, generator=g, device="cuda")
    if n2 == shape[-1]:
        rows[name] = median_ms(lambda: pair_fft.fft_pair(pr, pi, **kw))
        c = torch.complex(pr, pi)
        rows[name + " fft2"] = median_ms(lambda: torch.fft.fft2(c))
        del c
    else:
        rows[name] = median_ms(lambda: pair_fft.fft_pair_padded(
            pr, pi, n2=n2, **kw))
    if name == "K4":
        st = torch.cat([pr, pi], -1)
        rows["K17"] = median_ms(lambda: fused_fft.fft_pair_fused(st, **kw))
        del st
    del pr, pi

for name, shape in (("K2", (100, 640, 480)), ("K2_241", (100, 640, 241)),
                    ("K2_93", (1, 93, 1000000)),
                    ("K2_1920", (10, 1920, 1080)),
                    ("K2_3840", (1, 3840, 2160))):
    if want(name):
        xr = torch.randn(*shape, generator=g, device="cuda")
        xi = torch.randn(*shape, generator=g, device="cuda")
        rows[name] = median_ms(lambda: inner_fft.fft_inner(xr, xi, **kw))
        if name != "K2_93":
            c = torch.complex(xr, xi)
            rows[name + " cuFFT"] = median_ms(lambda: torch.fft.fft(c, dim=1))
            del c
        del xr, xi
if want("K3"):
    xr = torch.randn(1280, 128, 128, generator=g, device="cuda")
    xi = torch.randn(1280, 128, 128, generator=g, device="cuda")
    rows["K3"] = median_ms(lambda: inner_fft.fft_inner_nd(xr, xi, n=128,
                                                          **kw))
    del xr, xi
if want("K3_tw"):
    from tpufft_torch import execute
    a, b = execute._split_large(1048576)
    xr = torch.randn(16 * a, b, 1, generator=g, device="cuda")
    xi = torch.randn(16 * a, b, 1, generator=g, device="cuda")
    tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
    rows["K3_tw"] = median_ms(lambda: inner_fft.fft_inner_nd(
        xr, xi, n=a, twiddle=tw, **kw))
    del xr, xi
for name, shape in (("K18", (10, 128, 128, 256)),
                    ("K19", (1024, 128, 1, 512))):
    if want(name):
        st = torch.randn(*shape, generator=g, device="cuda")
        rows[name] = median_ms(lambda: fused_fft.fft_inner_fused(st, **kw))
        del st
if want("fft2"):
    import tpufft_torch
    x = SplitComplex(torch.randn(100, 640, 480, generator=g, device="cuda"),
                     torch.randn(100, 640, 480, generator=g, device="cuda"))
    rows["fft2"] = median_ms(lambda: tpufft_torch.fft2(x))
    del x

for name, shape in (("P3", (10, 128, 128, 128)), ("P4", (16, 64, 128, 256))):
    if not want(name):
        continue
    plan = plan_fft(shape, axes=(1, 2, 3), layout="lane-fused")
    pr = torch.randn(*shape, generator=g, device="cuda")
    pi = torch.randn(*shape, generator=g, device="cuda")
    packed = plan.pack(SplitComplex(pr, pi))
    rows[name] = median_ms(lambda: plan(packed))
    del pr, pi, packed

if want("K11", "K12", "K10"):
    from tpufft_torch import realtrans
    from tpufft_torch.kernels import dense_mm
    torch.backends.cuda.matmul.allow_tf32 = False
    xr = torch.randn(100000, 512, generator=g, device="cuda")
    xi = torch.randn(100000, 512, generator=g, device="cuda")
    wr = torch.randn(512, 512, generator=g, device="cuda")
    wi = torch.randn(512, 512, generator=g, device="cuda")
    if want("K11"):
        rows["K11"] = median_ms(lambda: dense_mm.dense_mm_real(xr, wr))
    if want("K10"):
        # the block table of the tensor-core body, uploaded once, where the
        # checkout has one
        kw = ({"wb": dense_mm.block_table(wr, wi).contiguous()}
              if hasattr(dense_mm, "block_table") else {})
        rows["K10"] = median_ms(lambda: dense_mm.dense_mm_complex(
            xr, xi, wr, wi, **kw))
    del xr, xi, wr, wi
    if want("K12"):
        x = torch.randn(100000, 1024, generator=g, device="cuda")
        w = realtrans._table(("dct", 2, 1024, "backward", False),
                             torch.device("cuda"))
        rows["K12"] = median_ms(lambda: dense_mm.r2r_minor(x, w))
        del x

if want("K14", "K15", "spectral"):
    x = torch.randn(64, 1048576, generator=g, device="cuda")
    y = torch.randn(64, 1048576, generator=g, device="cuda")
    win = np.hanning(257)[:-1]
    dev = torch.device("cuda")
    if want("K14"):
        xe = torch.nn.functional.pad(x, (128, 128))
        nseg = 1 + (xe.shape[1] - 256) // 128
        args = spectral._frame_tables(win, 256, 1.0 / win.sum(), dev) + (
            256, None, 128, nseg)
        zr, zi = stft_mm.stft_frames(xe, *args)
        if hasattr(stft_mm, "istft_frames"):
            syn = spectral._frame_tables(win, 256, float(win.sum()), dev)
            rows["K14"] = median_ms(lambda: stft_mm.istft_frames(
                zr, zi, *syn, 256, 128))
        else:
            ar, ai = spectral._tables("istft", win, 256, 256,
                                      float(win.sum()), dev)
            rows["K14"] = median_ms(lambda: stft_mm.istft_ola(zr, zi, ar, ai,
                                                              128))
        if want("spectral"):
            import tpufft_torch
            Z = torch.complex(zr, zi).transpose(1, 2)
            rows["istft"] = median_ms(lambda: tpufft_torch.istft(Z))
            del Z
        del xe, zr, zi
    if want("K15"):
        if "win" in inspect.signature(stft_mm.welch_accum).parameters:
            w32 = torch.tensor(win, dtype=torch.float32, device="cuda")
            k15 = (w32, 256, "constant", 128)
        else:
            k15 = spectral._tables("stft", win, 256, 256, ("constant", 1.0),
                                   dev) + (128,)
        rows["K15"] = median_ms(lambda: stft_mm.welch_accum(x, *k15))
        rows["K15_csd"] = median_ms(lambda: stft_mm.welch_accum(
            x, *k15, y=y))
    if want("spectral"):
        import tpufft_torch
        rows["welch"] = median_ms(lambda: tpufft_torch.welch(x))
        rows["csd"] = median_ms(lambda: tpufft_torch.csd(x, y))
        rows["coherence"] = median_ms(lambda: tpufft_torch.coherence(x, y))
    del x, y

if want("filter_real", "dct", "dst4", "filter_complex", "hilbert"):
    import tpufft_torch
    bins = np.minimum(np.arange(512), 512 - np.arange(512))
    lowpass = tpufft_torch.plan_filter(512, response=(bins <= 64) * 1.0)
    for name, shape, call in (
            ("filter_real", (100000, 512), lowpass),
            ("filter_complex", (100000, 512), lowpass),
            ("hilbert", (100000, 512), tpufft_torch.hilbert),
            ("dct", (100000, 1024), tpufft_torch.dct),
            ("dst4", (100000, 93), lambda x: tpufft_torch.dst(x, type=4))):
        if want(name):
            x = torch.randn(*shape, generator=g, device="cuda")
            if name == "filter_complex":
                x = torch.complex(x, x.flip(0))
            rows[name] = median_ms(lambda: call(x))
            del x
print(" ".join(f"{k} {v:.4f}" for k, v in rows.items()))
"""


def main() -> int:
    args = sys.argv[1:]
    rounds, only = 1, None
    while args and args[0].startswith("--"):
        flag, value = args[0], args[1]
        if flag == "--rounds":
            rounds = int(value)
        elif flag == "--only":
            only = value
        else:
            raise SystemExit(f"unknown option {flag}")
        args = args[2:]
    old = os.path.abspath(args[0])
    new = os.path.abspath(args[1] if len(args) > 1 else
                          os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    turns = (("old", old), ("new", new), ("new", new), ("old", old))
    for label, root in turns * rounds:
        env = dict(os.environ, PYTHONPATH=root)
        if only:
            env["AB_ONLY"] = only
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
