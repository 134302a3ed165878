"""Batched real-input FFT along the contiguous minor axis and its inverse:
the CUDA kernels, their wrappers, and their plain PyTorch versions.

Counterpart of two Pallas TPU kernels of ``tpufft/kernels/mxu_fft.py``:

* ``_build_minor_r2c`` (K7): real (batch, n) -> the (batch, n//2+1) half
  spectrum as re/im planes, scale folded in: :func:`rfft_minor`;
* ``_build_minor_c2r`` (K8): (batch, n//2+1) re/im planes -> real
  (batch, n), the imaginary parts of the DC and (even n) Nyquist bins
  ignored, as numpy's ``irfft`` does: :func:`irfft_minor`.

Storage is f32 or bf16 and arithmetic f32, as for K1. The TPU kernels are
dense (n, n//2+1) matmuls; the CUDA kernels (``csrc/real_fft.cu``) run an
even n = 2m as a length-m C2C on the packed row x[2j] + i x[2j+1] with the
Hermitian untangle fused into the store (rfft) or the load (irfft), and an
odd n as the length-n C2C of the real row (rfft) or of the Hermitian
extension (irfft). Both have two forms (:func:`form`). The line form runs
K1's four-step with each row in registers: at the half m of an even n
whose half is a power of two from 128 to 4096 (n = 256 to 8192) or a
mixed-radix length of K1's family lists (``_REAL_STEP``: 3, 5 and 15
times a power of two, 93, 1000, 1080, 2160), with one extra pass through
the tile (K7: the untangle after the passes; K8: the tangle before them;
``csrc/real_fft.cuh``), and at the odd n of ``_ODD_LINES`` (93) on the
length-n four-step itself (K7 stores the bins up to n/2, K8 gathers the
Hermitian extension in its load). Every other length runs the stage form,
one shared-memory Stockham pass. Their envelope
(:func:`supported`): an even n whose half is inside K1's envelope
(n <= 32768), or an odd n inside it (n <= 16383, prime factors <= 127).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises, never falls back. ``launches["r2c"]`` and ``launches["c2r"]`` count
launches; ``reference_cuda_calls`` counts runs of the plain versions on
CUDA tensors, which the main path never makes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..twiddle import exact_quarter_cleanup
from . import minor_fft

__all__ = [
    "form",
    "irfft_minor",
    "irfft_minor_reference",
    "launched_geometry",
    "launches",
    "line_geometry",
    "reference_cuda_calls",
    "reset_counts",
    "rfft_minor",
    "rfft_minor_reference",
    "supported",
]

launches = {"r2c": 0, "c2r": 0}
reference_cuda_calls = 0

# K7's and K8's line form at an even real length n = 2m (csrc/real_fft.cuh,
# with_line_step): m -> (N1, N2, warps a team, threads a block), the
# power-of-two four-step of K1's LaneStep at the half m, 32 values a lane
# in the XOR tile: K1's own up to 2048, and at 4096, where K1 takes three
# factors, a 64 x 64 of their own. A CPU test holds this table equal to
# the header's list.
_HALF_STEP = {**minor_fft._POW2_STEP, 4096: (64, 64, 4, 256)}
# The mixed-radix line form at an even real length n = 2m (csrc/
# real_fft.cuh, TPUFFT_REAL_{R3,R5,R15,ODD}, one source a family,
# real_line_*.cu): m -> (ZS and ZH of K7, ZS and ZH of K8) on K1's own
# four-step at m (minor_fft._FOUR_STEP). The untangle (K7) and the tangle
# (K8) hold Z of team row r at r ZS + k in the tile and take the pairs (k,
# m - k) of slot e = t + lanes i, r = e / ZH, k = e mod ZH, k < ceil(m/2);
# ZS and ZH were found by a search so that every half warp of pass 2's Z
# writes and the untangle's reads (K7), and of the tangle's writes and pass
# 1's reads (K8), touches distinct bank pairs. A CPU test holds this table
# equal to the header's lists and walks each tile.
_REAL_STEP = {
    # 3 2^a
    12: (12, 16, 19, 16), 24: (24, 16, 35, 16), 48: (51, 32, 56, 24),
    96: (102, 48, 96, 48), 192: (200, 96, 200, 96),
    384: (392, 192, 384, 192), 768: (768, 384, 768, 384),
    1536: (1536, 768, 1536, 768), 3072: (3072, 1536, 3072, 1536),
    # 5 2^a
    20: (20, 16, 21, 16), 40: (40, 24, 53, 27), 80: (85, 48, 88, 40),
    160: (165, 80, 160, 80), 320: (325, 160, 320, 160),
    640: (650, 320, 640, 320), 1280: (1280, 640, 1280, 640),
    2560: (2560, 1280, 2560, 1280),
    # 15 2^a
    30: (30, 16, 30, 16), 60: (60, 32, 60, 32), 120: (120, 64, 120, 64),
    240: (248, 120, 248, 120), 480: (488, 240, 480, 240),
    960: (960, 480, 960, 480), 1920: (1920, 960, 1920, 960),
    3840: (3840, 1920, 3840, 1920),
    # the odd list
    93: (93, 48, 99, 48), 1000: (1000, 500, 1000, 500),
    1080: (1080, 544, 1092, 544), 2160: (2160, 1080, 2160, 1080),
}
_REAL_KEYS = ("untangle_rs", "untangle_slots", "tangle_rs", "tangle_slots")
# Odd real lengths on K1's four-step at n itself (TPUFFT_REAL_ODD_N).
_ODD_LINES = (93,)


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global reference_cuda_calls
    for k in launches:
        launches[k] = 0
    reference_cuda_calls = 0


def _stage_length(n: int) -> int:
    """Length of the C2C stages the kernels run for a real length n."""
    return n // 2 if n % 2 == 0 else n


def supported(n: int, dtype) -> bool:
    """Is the real length n in storage ``dtype`` inside the kernels'
    envelope? Every length tpufft's K7/K8 take (2 <= n <= 1024) whose
    stage length is inside K1's envelope is; the primes 131 to 1021 are
    not (they run the C2C ladder)."""
    n = int(n)
    return n >= 2 and minor_fft.supported(_stage_length(n), dtype)


def form(n: int) -> str | None:
    """Which form of K7 and K8 transforms real rows of length n:
    ``"lines"`` for even n whose half is a power of two from 128 to
    ``minor_fft.LINE_MAX_N`` (n = 256 to 8192) or a length of
    ``_REAL_STEP`` (n = 24 to 7680), and for the odd n of ``_ODD_LINES``
    (93); ``"stages"`` for every other length in the envelope, None
    outside it. Mirrors ``launch_r2c_sized`` and ``launch_c2r_sized`` in
    ``csrc/real_fft.cu``, which make the choice at the launch
    (``tpufft_real_line_geometry`` reports it)."""
    n = int(n)
    if n < 2 or not minor_fft._length_ok(_stage_length(n)):
        return None
    m = n // 2
    if n % 2:
        lines = n in _ODD_LINES
    else:
        lines = ((128 <= m <= minor_fft.LINE_MAX_N and m & (m - 1) == 0)
                 or m in _REAL_STEP)
    return "lines" if lines else "stages"


def line_geometry(n: int) -> dict | None:
    """The four-step geometry of K7's and K8's line form at real length n,
    with the keys of ``minor_fft.line_geometry``'s four-step: at a
    power-of-two half m = n/2, ``_HALF_STEP``'s (``rows`` = 1024 W / m,
    ``q1`` = N2, ``q2`` = N1, ``p2`` = ``rs`` = 0, the XOR tile); at a
    mixed-radix half, K1's own at m and the (un)tangle's tile rows and pair
    slots (``_REAL_KEYS``, from ``_REAL_STEP``); at an odd n of
    ``_ODD_LINES``, K1's own at n. None where n does not run the line
    form."""
    if form(n) != "lines":
        return None
    n = int(n)
    if n % 2:
        return minor_fft.line_geometry(n)
    m = n // 2
    if m in _REAL_STEP:
        return {**minor_fft.line_geometry(m),
                **dict(zip(_REAL_KEYS, _REAL_STEP[m]))}
    n1, n2, w, th = _HALF_STEP[m]
    return dict(zip(minor_fft._FOUR_STEP_KEYS,
                    (n1, n2, w, th, 1024 * w // m, n2, n1, 0, 0)))


def launched_geometry(n: int) -> dict | None:
    """The form the library launches at real length n (K7 and K8 alike),
    read from ``tpufft_real_line_geometry`` (the launch's own test; needs
    the CUDA toolkit): ``{"form": "stages"}``, or ``"form": "lines"`` with
    the keys of :func:`line_geometry`. A card test holds it equal to
    :func:`form` and :func:`line_geometry`."""
    lib = _build.load()
    out = (ctypes.c_int * 13)()
    kind = lib.tpufft_real_line_geometry(int(n), out)
    if kind == 0:
        return {"form": "stages"}
    keys = minor_fft._FOUR_STEP_KEYS + (_REAL_KEYS if kind == 3 else ())
    return {"form": "lines", **dict(zip(keys, out))}


@functools.lru_cache(maxsize=64)
def _device_half_twiddle(n: int, device: torch.device) -> torch.Tensor:
    """W^k = exp(-2 pi i k / n), k = 0..n/2, as (n/2 + 1, 2) f32 on
    ``device``: host float64 trig with exact quarter points (tpufft's
    ``_half_twiddle``)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    theta = (-2.0 * np.pi / n) * k
    w = exact_quarter_cleanup(np.cos(theta) + 1j * np.sin(theta), k, float(n))
    return torch.from_numpy(
        np.stack([w.real, w.imag], axis=-1).astype(np.float32)).to(device)


def _check_plane(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the plane must lie on a CUDA device, "
                         f"got {x.device}")
    if x.dtype not in minor_fft.STORAGE_DTYPES:
        raise ValueError(f"{name}: the plane must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: the plane must be a contiguous "
                         f"(batch, n) matrix, got {tuple(x.shape)}")


def _check_length(name: str, n: int, dtype) -> None:
    if not supported(n, dtype):
        raise ValueError(
            f"{name}: real length {n} is outside the kernel's envelope "
            f"(even n with n/2 inside K1's, or odd n inside K1's: "
            f"n <= {minor_fft.MAX_N}, prime factors <= {minor_fft.MAX_PRIME})")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it, whose data pointer allows the kernel's paired
    (8-byte f32, 4-byte bf16) loads."""
    return x if x.data_ptr() % (2 * x.element_size()) == 0 else x.clone()


def _launch_args(n: int, inverse: bool, device: torch.device):
    L = _stage_length(n)
    rad = minor_fft.radices(L)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    tw = minor_fft._device_twiddles(L, inverse, device)
    half = _device_half_twiddle(n, device)
    return tw, half, rad_arr, len(rad)


def rfft_minor(x: torch.Tensor, *, scale: float,
               stages: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The (batch, n//2+1) half spectrum of the real (batch, n) plane,
    times ``scale``, as re/im planes in the storage dtype of ``x``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    :func:`form` on the current stream (``stages``: the stage form at
    every length, kept to compare the forms) and raise on anything it does
    not take."""
    if x.device.type == "cpu":
        return rfft_minor_reference(x, scale=scale)
    _check_plane("rfft_minor", x)
    batch, n = x.shape
    _check_length("rfft_minor", n, x.dtype)
    yr = x.new_empty((batch, n // 2 + 1))
    yi = torch.empty_like(yr)
    if batch == 0:
        return yr, yi
    if n % 2 == 0:
        x = _aligned(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        tw, half, rad_arr, nstages = _launch_args(n, False, x.device)
        entry = lib.tpufft_rfft_stages if stages else lib.tpufft_rfft
        err = entry(
            x.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw.data_ptr(),
            half.data_ptr(), batch, n, rad_arr, nstages, float(scale),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rfft_minor launch failed: CUDA error {err}")
    launches["r2c"] += 1
    return yr, yi


def irfft_minor(xr: torch.Tensor, xi: torch.Tensor, *, n: int,
                scale: float, stages: bool = False) -> torch.Tensor:
    """The real (batch, n) plane synthesized from the (batch, n//2+1)
    half-spectrum planes, times ``scale`` (1/n is numpy's ``irfft``), in
    their storage dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    :func:`form` on the current stream (``stages``: the stage form at
    every length, kept to compare the forms) and raise on anything it does
    not take."""
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return irfft_minor_reference(xr, xi, n=n, scale=scale)
    minor_fft.check_planes("irfft_minor", xr, xi, 2)
    n = int(n)
    batch, m1 = xr.shape
    _check_length("irfft_minor", n, xr.dtype)
    if m1 != n // 2 + 1:
        raise ValueError(f"irfft_minor: planes of {m1} bins for length {n}, "
                         f"expected {n // 2 + 1}")
    y = xr.new_empty((batch, n))
    if batch == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(xr.device):
        tw, half, rad_arr, nstages = _launch_args(n, True, xr.device)
        entry = lib.tpufft_irfft_stages if stages else lib.tpufft_irfft
        err = entry(
            xr.data_ptr(), xi.data_ptr(), y.data_ptr(), tw.data_ptr(),
            half.data_ptr(), batch, n, rad_arr, nstages, float(scale),
            int(xr.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"irfft_minor launch failed: CUDA error {err}")
    launches["c2r"] += 1
    return y


# ----------------------------------------------------------------------------
# Plain versions: the full-length C2C of K1's plain version, no packing
# ----------------------------------------------------------------------------

def rfft_minor_reference(x: torch.Tensor, *,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`rfft_minor`: K1's plain version on
    (x, 0) at length n, then the first n//2+1 bins; any device."""
    global reference_cuda_calls
    if x.is_cuda:
        reference_cuda_calls += 1
    n = x.shape[-1]
    zr, zi = minor_fft.fft_minor_reference(x, torch.zeros_like(x),
                                           inverse=False, scale=scale)
    return (zr[..., :n // 2 + 1].contiguous(),
            zi[..., :n // 2 + 1].contiguous())


def irfft_minor_reference(xr: torch.Tensor, xi: torch.Tensor, *, n: int,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`irfft_minor`: the Hermitian
    extension X[n-k] = conj X[k] to length n, K1's plain version inverse,
    and its real plane; any device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    n = int(n)
    store = xr.dtype
    ar, ai = xr.float(), xi.float()
    mirror = slice(1, (n + 1) // 2)
    fr = torch.cat([ar, ar[..., mirror].flip(-1)], dim=-1)[..., :n]
    fi = torch.cat([ai, -ai[..., mirror].flip(-1)], dim=-1)[..., :n]
    zr, _ = minor_fft.fft_minor_reference(fr.contiguous(), fi.contiguous(),
                                          inverse=True, scale=scale)
    return zr.to(store)
