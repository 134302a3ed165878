"""Per-axis dispatch (counterpart of ``tpufft/execute.py``).

For each transformed axis, decide by predicate, before any launch:

* a length and storage dtype inside the CUDA kernels' envelope
  (``kernels/minor_fft.supported``) go to the kernel the axis's layout
  picks (:func:`_kernel_axis`): the minor-axis kernel for the contiguous
  axis, the strided-axis kernel (``kernels/inner_fft``) for any other,
  reading the array where it lies. tpufft moves an axis with a trailing
  product below 32 minor instead (``mxu_fft.py:2542``); on the H100 the
  strided kernel beat that route (copy, minor kernel, copy back) at every
  trailing product from 2 up (PERF.md), so the port never moves an axis;
* a longer f32/bf16 length n = a*b with both factors inside the envelope
  runs the two-pass split (:func:`_fft_axis_two_pass`): two launches of
  the strided kernel, the digit swap folded into the first one's store;
* a length with a prime factor above 1024 (any length under
  ``backend="pallas"``) runs Bluestein (:func:`_fft_axis_bluestein`),
  whose two padded transforms come back through this ladder;
* anything else (float64, ``backend="xla"``, what is left) runs the
  torch-op Stockham of ``core.py`` on the planes' device, bf16 planes
  widened to f32 around it; ``backend="pallas"`` raises there instead.

Every wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. :func:`fft_cube_last` runs a plan's three trailing
axes in one pass of the cube kernel (``kernels/cube_fft``) when
:func:`cube_supported` says it fits; :func:`fft_mid_pair` runs two
adjacent middle axes in one pass of the mid-pair kernel
(``kernels/mid_pair_fft``) when :func:`mid_pair_ok` says so.
:func:`fft_pair_last` runs a plan's two trailing
axes in one pass of the pair kernel (``kernels/pair_fft``) when
:func:`pair_supported` says it fits, and with ``n2_out`` zero-pads the minor
axis inside that pass (:func:`pair_pad_ok`). :func:`fft_axis_padded` runs
a zero-padded minor axis as one pass of K9, the minor-axis kernel with a
bound on its load (:func:`pad_axis_ok`). :func:`rfft_minor` and
:func:`irfft_minor` run the real transforms of one axis on K7 and K8
(``kernels/real_fft``) when :func:`r2c_minor_supported` says they fit,
moving a non-minor axis minor and back as tpufft does.
:func:`fft_cube_fused`, :func:`fft_pair_fused`, :func:`fft_minor_fused`
and :func:`fft_axis_fused` run the passes of a lane-fused plan on fused
storage, ONE real array whose minor logical rows hold [re | im]
(``kernels/fused_fft``, K16-K20).

Every entry point is differentiable (``_FFTAxis``, ``_FFTPair``,
``_FFTCube``, ``_FFTMidPair``, ``_FFTPadded``, ``_RFFTMinor``,
``_IRFFTMinor``, ``_FFTFused``): the split-plane DFT is
the real-linear map [[Fr, -Fi], [Fi, Fr]] with F symmetric, so its
transpose applied to g is the same transform with the opposite sign and
the same scale; a zero-pad's transpose is the crop; rfft's is the
opposite-sign transform of the gradient zero-padded to n bins, real
plane; irfft's is c_k times the forward real transform of the gradient,
with c_k = 1 at DC and Nyquist and 2 elsewhere.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import core
from .config import PlanConfig
from .kernels import (cube_fft, fused_fft, inner_fft, mid_pair_fft,
                      minor_fft, pair_fft, real_fft)
from .planner import default_bases, factorize, next_fast_len

__all__ = [
    "MID_PAIR_MIN_L", "cube_supported", "fft_axis", "fft_axis_fused",
    "fft_axis_padded", "fft_cube_fused", "fft_cube_last", "fft_mid_pair",
    "fft_minor_fused", "fft_pair_fused", "fft_pair_last", "irfft_minor",
    "mid_pair_ok", "pad_axis_ok", "pair_pad_ok", "pair_supported",
    "r2c_minor_supported", "rfft_minor",
]

# Bluestein under backend="auto" only for a prime factor above this; below
# it tpufft measured the direct stages faster (tpufft/execute.py:271).
BLUESTEIN_MIN_PRIME = 1024


def _kernel_axis(ar, ai, axis: int, *, inverse: bool, scale: float):
    """One axis of a length inside the kernels' envelope, on the kernel its
    layout picks: minor (K1), strided with one trailing dim (K2), or
    strided with several (K3)."""
    if ai is None:
        ai = torch.zeros_like(ar)
    shape = ar.shape
    n = shape[axis]
    pre = math.prod(shape[:axis])
    post = math.prod(shape[axis + 1:])
    if post == 1:
        outr, outi = minor_fft.fft_minor(
            ar.reshape(pre, n).contiguous(), ai.reshape(pre, n).contiguous(),
            inverse=inverse, scale=scale)
    elif axis == ar.ndim - 2:
        view = (pre, n, post)
        outr, outi = inner_fft.fft_inner(
            ar.reshape(view).contiguous(), ai.reshape(view).contiguous(),
            inverse=inverse, scale=scale)
    else:
        view = (pre * n, post // shape[-1], shape[-1])
        outr, outi = inner_fft.fft_inner_nd(
            ar.reshape(view).contiguous(), ai.reshape(view).contiguous(),
            n=n, inverse=inverse, scale=scale)
    return outr.reshape(shape), outi.reshape(shape)


# ----------------------------------------------------------------------------
# Two-pass split for lengths above the single-pass envelope
# ----------------------------------------------------------------------------

# Pass 1's lengths, in order of preference: those where the strided line
# form restages its swapped store through the tile (strided_line.cuh,
# kRestage), first in both storages (the line form takes bf16 up to 1024),
# then in f32 only. On the H100 pass 1 there ran 1.9-2.9x faster than
# stored straight from registers, and a = 1024 ran every path of the sweep
# fastest or within 4 % (2**15 to 2**24; PERF.md, tools/two_pass_ab.py).
_PASS1 = (1024, 960, 480, 2048, 1920, 1536, 1280)


@functools.lru_cache(maxsize=None)
def _split_large(n: int):
    """Factor n into a * b with both factors inside the kernels' envelope:
    pass 1 over a, the first of ``_PASS1`` that divides n with b inside the
    envelope too; else a >= b and as balanced as possible (pass 1 stores
    straight); None if there is no such split."""
    if n < 4:
        return None
    for a in _PASS1:
        if (n % a == 0 and minor_fft.supported(n // a, torch.float32)
                and n // a > 1):
            return a, n // a
    best = None
    d = 2
    while d * d <= n:
        if (n % d == 0 and minor_fft.supported(n // d, torch.float32)
                and minor_fft.supported(d, torch.float32)):
            best = (n // d, d)  # last hit = most balanced (d grows to sqrt)
        d += 1
    return best


@functools.lru_cache(maxsize=None)
def _two_pass_twiddle(a: int, b: int, inverse: bool):
    """Host f64 inter-factor twiddle T[ka, ib] = e^{-+2 pi i ka ib / (a b)}
    of the n = a*b split (tpufft's ``_two_pass_twiddle``)."""
    sign = 1.0 if inverse else -1.0
    k = np.outer(np.arange(a, dtype=np.float64),
                 np.arange(b, dtype=np.float64))
    theta = (sign * 2.0 * np.pi / (a * b)) * k
    return np.cos(theta), np.sin(theta)


@functools.lru_cache(maxsize=16)
def _device_two_pass_twiddle(a: int, b: int, inverse: bool,
                             device: torch.device) -> torch.Tensor:
    """T as the strided kernel's (a, b, 2) f32 table on ``device``."""
    c, s = _two_pass_twiddle(a, b, inverse)
    table = np.stack([c, s], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _fft_axis_two_pass(ar, ai, axis: int, a: int, b: int, *, inverse: bool,
                       scale: float, _three_step: bool = False):
    """Four-step split of a length n = a*b beyond the single-pass envelope.

    With the flat index i = ia*b + ib along the axis, viewing it as (pre,
    a, b, post) is free. Pass 1 transforms ia on the strided kernel (K3)
    with the inter-factor twiddle T[ka, ib] applied at its store, which
    writes (pre, b, a, post) planes: the digit swap. Pass 2 transforms ib
    of their (pre, b, a*post) view on the strided kernel (K2), whose store
    is already the natural order k = kb*a + ka. Two launches, no copy, at
    any axis. Unlike tpufft, no axis-to-front transposes are needed: those
    exist for the TPU's lane layout.

    ``_three_step`` runs the route this one replaced (pass 1 in the
    natural order, pass 2 on the kernel its layout picks, K1 for a minor
    axis, then one transpose copy), kept to compare the two
    (``tools/two_pass_ab.py``)."""
    if ai is None:
        ai = torch.zeros_like(ar)
    shape = ar.shape
    pre = math.prod(shape[:axis])
    post = math.prod(shape[axis + 1:])
    view = (pre * a, b, post)
    tw = _device_two_pass_twiddle(a, b, bool(inverse), ar.device)
    yr, yi = inner_fft.fft_inner_nd(
        ar.reshape(view).contiguous(), ai.reshape(view).contiguous(), n=a,
        inverse=inverse, scale=1.0, twiddle=tw, swap=not _three_step)
    if _three_step:
        yr, yi = _kernel_axis(yr, yi, 1, inverse=inverse, scale=scale)
        split = (pre, a, b, post)
        return (yr.reshape(split).transpose(1, 2).reshape(shape),
                yi.reshape(split).transpose(1, 2).reshape(shape))
    swapped = (pre, b, a * post)
    outr, outi = inner_fft.fft_inner(yr.reshape(swapped),
                                     yi.reshape(swapped), inverse=inverse,
                                     scale=scale)
    return outr.reshape(shape), outi.reshape(shape)


# ----------------------------------------------------------------------------
# Bluestein for lengths with large prime factors
# ----------------------------------------------------------------------------

def _bluestein_ok(n: int, config: PlanConfig) -> bool:
    """Does length n take Bluestein? Under ``backend="auto"`` only for a
    prime factor above ``BLUESTEIN_MIN_PRIME``; under "pallas" for any
    n >= 8. Either way the padded length m must run on the kernels (single
    pass or two-pass), so the recursion never comes back here."""
    if n < 8:
        return False
    if (config.backend != "pallas"
            and max(factorize(n)) <= BLUESTEIN_MIN_PRIME):
        return False
    m = next_fast_len(2 * n - 1, aligned=True)
    return (minor_fft.supported(m, torch.float32)
            or _split_large(m) is not None)


@functools.lru_cache(maxsize=None)
def _bluestein_tables(n: int, m: int, inverse: bool, scale: float):
    """Host chirp constants (tpufft's ``_bluestein_tables``): the input
    chirp c[k] = exp(+-i pi k^2 / n) with the exact reduction k^2 mod 2n,
    the output chirp with the scale folded in, and FFT_m of the wrapped
    conjugate chirp; f32 numpy arrays (cr, ci, c_out_r, c_out_i, Br, Bi)."""
    k = np.arange(n, dtype=np.int64)
    sq = (k * k) % (2 * n)
    ang = np.pi * sq.astype(np.float64) / n
    s = 1.0 if inverse else -1.0
    cr = np.cos(ang)
    ci = s * np.sin(ang)
    b = np.zeros(m, np.complex128)
    conj_c = cr - 1j * ci
    b[:n] = conj_c
    b[m - n + 1:] = conj_c[1:][::-1]          # b[m-j] = conj(c[j])
    B = np.fft.fft(b)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(cr), f32(ci), f32(cr * scale), f32(ci * scale),
            f32(B.real), f32(B.imag))


@functools.lru_cache(maxsize=16)
def _device_bluestein_tables(n: int, m: int, inverse: bool, scale: float,
                             device: torch.device):
    return tuple(torch.from_numpy(t).to(device)
                 for t in _bluestein_tables(n, m, inverse, scale))


def _fft_axis_bluestein(ar, ai, axis: int, *, inverse: bool, scale: float,
                        config: PlanConfig):
    """Bluestein (chirp-z): the DFT as a circular convolution of the
    chirped input with a fixed chirp, evaluated as FFT_m -> pointwise ->
    IFFT_m at a kernel-friendly m >= 2n - 1. The chirp multiplies, the pad
    and the crop are torch ops on the planes (f32; bf16 planes come back
    bf16); the two length-m transforms run through the kernel ladder."""
    n = ar.shape[axis]
    m = next_fast_len(2 * n - 1, aligned=True)
    if ai is None:
        ai = torch.zeros_like(ar)
    in_dtype = ar.dtype
    cr, ci, por, poi, Br, Bi = _device_bluestein_tables(
        n, m, bool(inverse), float(scale), ar.device)
    ar, ai = ar.movedim(axis, -1), ai.movedim(axis, -1)
    shape = ar.shape
    ar, ai = ar.reshape(-1, n), ai.reshape(-1, n)
    pr = F.pad(ar * cr - ai * ci, (0, m - n))
    pi = F.pad(ar * ci + ai * cr, (0, m - n))
    pr, pi = _fft_axis_impl(pr, pi, 1, (), inverse=False, scale=1.0,
                            config=config)
    pr, pi = pr * Br - pi * Bi, pr * Bi + pi * Br
    pr, pi = _fft_axis_impl(pr, pi, 1, (), inverse=True, scale=1.0 / m,
                            config=config)
    pr, pi = pr[:, :n], pi[:, :n]
    outr = (pr * por - pi * poi).to(in_dtype).reshape(shape)
    outi = (pr * poi + pi * por).to(in_dtype).reshape(shape)
    return outr.movedim(-1, axis), outi.movedim(-1, axis)


def _fft_axis_impl(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool,
    scale: float,
    config: PlanConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform one axis of the split planes on the path the predicates
    choose (tpufft's ``_fft_axis_impl`` ladder, without ``big_pass``: a row
    longer than 16384 does not fit shared memory, so the two-pass takes its
    place)."""
    n = ar.shape[axis]
    kernel_ok = config.backend != "xla"
    if kernel_ok and minor_fft.supported(n, ar.dtype):
        return _kernel_axis(ar, ai, axis, inverse=inverse, scale=scale)
    if kernel_ok and ar.dtype in minor_fft.STORAGE_DTYPES:
        two = _split_large(n)
        if two is not None:
            return _fft_axis_two_pass(ar, ai, axis, *two, inverse=inverse,
                                      scale=scale)
        if _bluestein_ok(n, config):
            return _fft_axis_bluestein(ar, ai, axis, inverse=inverse,
                                       scale=scale, config=config)
        if config.backend == "pallas":
            raise ValueError(
                f"backend='pallas' requested but axis length {n} is not "
                "factorable into kernel-supported components; use "
                "backend='auto' for automatic fallback"
            )
    elif config.backend == "pallas":
        raise ValueError(
            f"backend='pallas' requested but axis length {n} (dtype "
            f"{ar.dtype}) is not supported by the fused kernel; use "
            "backend='auto' for automatic fallback"
        )
    bf16 = ar.dtype == torch.bfloat16
    if bf16:
        ar = ar.float()
        ai = None if ai is None else ai.float()
    outr, outi = core.fft_along_axis(
        ar, ai, axis, bases, inverse=inverse, scale=scale
    )
    if bf16:
        outr, outi = outr.to(torch.bfloat16), outi.to(torch.bfloat16)
    return outr, outi


class _FFTAxis(torch.autograd.Function):
    """Differentiable one-axis transform; the backward is the transform of
    the opposite sign with the same scale. A real input (``ai=None``) gets
    only the real plane of that result as its gradient."""

    @staticmethod
    def forward(ctx, ar, ai, axis, bases, inverse, scale, config):
        ctx.args = (axis, bases, inverse, scale, config)
        ctx.real_input = ai is None
        return _fft_axis_impl(ar, ai, axis, bases, inverse=inverse,
                              scale=scale, config=config)

    @staticmethod
    def backward(ctx, gr, gi):
        axis, bases, inverse, scale, config = ctx.args
        br, bi = _FFTAxis.apply(gr, gi, axis, bases, not inverse, scale,
                                config)
        return br, (None if ctx.real_input else bi), None, None, None, None, None


def fft_axis(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool,
    scale: float,
    config: PlanConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform one axis of the split planes (differentiable)."""
    return _FFTAxis.apply(ar, ai, axis % ar.ndim, tuple(bases),
                          bool(inverse), float(scale), config)


# ----------------------------------------------------------------------------
# The trailing pair in one pass
# ----------------------------------------------------------------------------

def pair_supported(n1: int, n2: int, dtype, config: PlanConfig) -> bool:
    """Can the trailing (n1, n2) axes run as one pair-kernel pass? The
    port's own envelope (``pair_fft.supported``); tpufft's VMEM rule does
    not apply. A larger pair runs axis by axis with the same result."""
    return config.backend != "xla" and pair_fft.supported(n1, n2, dtype)


def pair_pad_ok(n1: int, n2_in: int, n2: int, dtype,
                config: PlanConfig) -> bool:
    """Can the trailing pair fuse the minor-axis zero-pad n2_in -> n2 into
    its pass (``pair_fft.fft_pair_padded``, tpufft's ``n2_io``)?"""
    return 1 <= n2_in < n2 and pair_supported(n1, n2, dtype, config)


def _pair_impl(ar, ai, *, inverse: bool, scale: float, n2: int | None):
    if ai is None:
        ai = torch.zeros_like(ar)
    shape = ar.shape
    view = (-1,) + tuple(shape[-2:])
    xr, xi = ar.reshape(view).contiguous(), ai.reshape(view).contiguous()
    if n2 is None:
        outr, outi = pair_fft.fft_pair(xr, xi, inverse=inverse, scale=scale)
    else:
        outr, outi = pair_fft.fft_pair_padded(xr, xi, n2=n2,
                                              inverse=inverse, scale=scale)
    out_shape = shape[:-1] + outr.shape[-1:]
    return outr.reshape(out_shape), outi.reshape(out_shape)


class _FFTPair(torch.autograd.Function):
    """Differentiable trailing-pair transform (tpufft's ``_fft_pair_diff``):
    the backward is the pair transform of the opposite sign with the same
    scale, cropped back to the input's minor length when the forward
    zero-padded it (n2 not None)."""

    @staticmethod
    def forward(ctx, ar, ai, inverse, scale, n2):
        ctx.args = (inverse, scale, ar.shape[-1], n2)
        ctx.real_input = ai is None
        return _pair_impl(ar, ai, inverse=inverse, scale=scale, n2=n2)

    @staticmethod
    def backward(ctx, gr, gi):
        inverse, scale, n2_in, n2 = ctx.args
        br, bi = _FFTPair.apply(gr, gi, not inverse, scale, None)
        if n2 is not None:
            br, bi = br[..., :n2_in], bi[..., :n2_in]
        return br, (None if ctx.real_input else bi), None, None, None


def fft_pair_last(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    *,
    inverse: bool,
    scale: float,
    n2_out: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the last two axes in one pass of the pair kernel
    (differentiable); the caller checks :func:`pair_supported`. ``n2_out``:
    zero-pad the minor axis to this length inside the pass (the caller
    checks :func:`pair_pad_ok`)."""
    n2 = None if n2_out is None or n2_out == ar.shape[-1] else int(n2_out)
    return _FFTPair.apply(ar, ai, bool(inverse), float(scale), n2)


# ----------------------------------------------------------------------------
# The trailing cube (K5) and two adjacent middle axes (K6) in one pass
# ----------------------------------------------------------------------------

# The mid-pair rule needs at least this contiguous batch L behind the pair;
# below it the two strided passes run. From chip_smoke.py's L sweep on the
# H100 (PERF.md): below 8, K6's line form computes on masked lanes of its
# 8-lane tiles; at L = 4 it ran 1.06x and its stage form 1.18x the two
# passes' time, at 1 and 2 both 2.2-7.1x; at 8 the line form ran 0.85x.
MID_PAIR_MIN_L = 8

# K6's line forms against the two strided passes: from tools/mid_route.py
# on the H100 (PERF.md; 23 pairs at L = 16, 48, 160), K3 + K2 on their
# line forms win where a block of K6's cluster holds more than this many
# elements (its tile at 8 lanes of L: 1.0-2.5x K6's time from 6144 up,
# 0.81-0.95x at 3200-4608) or where an axis is 15 2^a (1.2-2.2x at every
# share); K6 wins wherever an axis is 7 2^a (0.3-0.6x: the strided kernel
# runs its stage form there).
MID_MIXED_MAX_SHARE = 4608


def cube_supported(n1: int, n2: int, n3: int, dtype,
                   config: PlanConfig) -> bool:
    """Can the trailing (n1, n2, n3) axes run as one pass of the cube
    kernel? The port's own envelope (``cube_fft.supported``: a cluster of
    at most 16 blocks of 16384 elements, so at most 64^3); tpufft's VMEM
    and lane rules do not apply. A cube that tpufft fuses and the port does
    not (e.g. 128 x 128 x 64) runs the trailing pair and then n1, with the
    same result."""
    return config.backend != "xla" and cube_fft.supported(n1, n2, n3, dtype)


def _strided_line(n: int) -> bool:
    """Does the strided kernel run an axis of n <= 256 on its line form (r
    2^a from 8 for r in 1, 3, 5; 15 2^a from 30; 25 and 93; the lists of
    ``csrc/strided_line.cuh``)?"""
    odd = n // (n & -n)
    return (n >= 8 and odd in (1, 3, 5)) or (n >= 30 and odd == 15) or \
        n in (25, 93)


def _two_passes_win(n1: int, n2: int, L: int, dtype) -> bool:
    """Do K3 + K2 on their line forms beat K6's line forms at this pair
    (``MID_MIXED_MAX_SHARE``)? K2 takes its line form at L >= 8 columns in
    f32, 16 in bf16."""
    if (mid_pair_fft.form(n1, n2, L) not in ("lines", "mixed")
            or not (_strided_line(n1) and _strided_line(n2))
            or L < (16 if dtype == torch.bfloat16 else 8)):
        return False
    share = n1 // mid_pair_fft.cluster_size(n1, n2) * n2 * \
        mid_pair_fft.LINE_LANES
    return share > MID_MIXED_MAX_SHARE or any(
        n // (n & -n) == 15 for n in (n1, n2))


def mid_pair_ok(n1: int, n2: int, L: int, dtype, config: PlanConfig) -> bool:
    """Can two adjacent middle axes (n1, n2) with a contiguous batch L
    behind them run as one pass of the mid-pair kernel, and should they?
    The port's own envelope (``mid_pair_fft.supported``), ``L >=
    MID_PAIR_MIN_L``, and not a pair where the two strided passes run
    faster (:func:`_two_passes_win`); tpufft's lane rule (L a multiple of
    128) does not apply."""
    return (config.backend != "xla" and L >= MID_PAIR_MIN_L
            and mid_pair_fft.supported(n1, n2, L, dtype)
            and not _two_passes_win(n1, n2, L, dtype))


class _FFTCube(torch.autograd.Function):
    """Differentiable trailing-cube transform (tpufft's ``_fft_cube_diff``):
    the backward is the cube transform of the opposite sign with the same
    scale."""

    @staticmethod
    def forward(ctx, ar, ai, inverse, scale):
        ctx.args = (inverse, scale)
        ctx.real_input = ai is None
        if ai is None:
            ai = torch.zeros_like(ar)
        shape = ar.shape
        view = (-1,) + tuple(shape[-3:])
        outr, outi = cube_fft.fft_cube(
            ar.reshape(view).contiguous(), ai.reshape(view).contiguous(),
            inverse=inverse, scale=scale)
        return outr.reshape(shape), outi.reshape(shape)

    @staticmethod
    def backward(ctx, gr, gi):
        inverse, scale = ctx.args
        br, bi = _FFTCube.apply(gr, gi, not inverse, scale)
        return br, (None if ctx.real_input else bi), None, None


def fft_cube_last(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    *,
    inverse: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the last three axes in one pass of the cube kernel
    (differentiable); the caller checks :func:`cube_supported`."""
    return _FFTCube.apply(ar, ai, bool(inverse), float(scale))


class _FFTMidPair(torch.autograd.Function):
    """Differentiable transform of axes (a, a + 1) as one mid-pair pass
    over the (pre, n1, n2, L) view (tpufft's ``_fft_mid_pair_diff``): the
    backward is the same pass of the opposite sign with the same scale."""

    @staticmethod
    def forward(ctx, ar, ai, axis1, inverse, scale):
        ctx.args = (axis1, inverse, scale)
        ctx.real_input = ai is None
        if ai is None:
            ai = torch.zeros_like(ar)
        shape = ar.shape
        view = (math.prod(shape[:axis1]), shape[axis1], shape[axis1 + 1],
                math.prod(shape[axis1 + 2:]))
        outr, outi = mid_pair_fft.fft_mid_pair(
            ar.reshape(view).contiguous(), ai.reshape(view).contiguous(),
            inverse=inverse, scale=scale)
        return outr.reshape(shape), outi.reshape(shape)

    @staticmethod
    def backward(ctx, gr, gi):
        axis1, inverse, scale = ctx.args
        br, bi = _FFTMidPair.apply(gr, gi, axis1, not inverse, scale)
        return br, (None if ctx.real_input else bi), None, None, None


def fft_mid_pair(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis1: int,
    *,
    inverse: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the adjacent axes (axis1, axis1 + 1) in one pass of the
    mid-pair kernel over the free (pre, n1, n2, L) view, L the product of
    the axes behind them (differentiable); the caller checks
    :func:`mid_pair_ok`."""
    return _FFTMidPair.apply(ar, ai, axis1 % ar.ndim, bool(inverse),
                             float(scale))


# ----------------------------------------------------------------------------
# Passes on fused storage (K16-K20)
# ----------------------------------------------------------------------------

def _fused_impl(st, kind: str, axis: int, inverse: bool, scale: float):
    """One fused-storage pass over the free view its kernel takes."""
    shape = st.shape
    kw = dict(inverse=inverse, scale=scale)
    if kind == "cube":
        out = fused_fft.fft_cube_fused(
            st.reshape((-1,) + tuple(shape[-3:])).contiguous(), **kw)
    elif kind == "pair":
        out = fused_fft.fft_pair_fused(
            st.reshape((-1,) + tuple(shape[-2:])).contiguous(), **kw)
    elif kind == "minor":
        out = fused_fft.fft_minor_fused(
            st.reshape(-1, shape[-1]).contiguous(), **kw)
    else:
        view = (math.prod(shape[:axis]), shape[axis],
                math.prod(shape[axis + 1:-1]), shape[-1])
        out = fused_fft.fft_inner_fused(st.reshape(view).contiguous(), **kw)
    return out.reshape(shape)


class _FFTFused(torch.autograd.Function):
    """Differentiable fused-storage pass (tpufft's ``_fft_cube_fused_diff``,
    ``_fft_pair_fused_diff``, ``_fft_minor_fused_diff`` and
    ``_fft_axis_fused_diff``). On the stacked [re | im] real vector the DFT
    is A = [[Fr, -Fi], [Fi, Fr]], the split planes' map with its elements
    permuted; F symmetric makes A^T the opposite-sign transform with the
    same scale, so the backward is the same pass with the sign flipped."""

    @staticmethod
    def forward(ctx, st, kind, axis, inverse, scale):
        ctx.args = (kind, axis, inverse, scale)
        return _fused_impl(st, kind, axis, inverse, scale)

    @staticmethod
    def backward(ctx, g):
        kind, axis, inverse, scale = ctx.args
        return (_FFTFused.apply(g, kind, axis, not inverse, scale), None,
                None, None, None)


def fft_cube_fused(st: torch.Tensor, *, inverse: bool,
                   scale: float) -> torch.Tensor:
    """Transform the last three logical axes of a lane-fused
    (..., n1, n2, 2*n3) array in one K16 pass (differentiable); the caller
    checks ``fused_fft.cube_supported``."""
    return _FFTFused.apply(st, "cube", -1, bool(inverse), float(scale))


def fft_pair_fused(st: torch.Tensor, *, inverse: bool,
                   scale: float) -> torch.Tensor:
    """Transform the last two logical axes of a lane-fused (..., n2, 2*n3)
    array in one K17 pass (differentiable); the caller checks
    ``fused_fft.pair_supported``."""
    return _FFTFused.apply(st, "pair", -1, bool(inverse), float(scale))


def fft_minor_fused(st: torch.Tensor, *, inverse: bool,
                    scale: float) -> torch.Tensor:
    """Transform the minor logical axis of a lane-fused (..., 2*n) array in
    one K20 pass (differentiable); the caller checks
    ``fused_fft.minor_supported``."""
    return _FFTFused.apply(st, "minor", -1, bool(inverse), float(scale))


def fft_axis_fused(st: torch.Tensor, axis: int, *, inverse: bool,
                   scale: float) -> torch.Tensor:
    """Transform a leading logical ``axis`` of a lane-fused (..., 2*n_minor)
    array in one K18 pass (K19 when it is the axis next to the minor one;
    differentiable); the caller checks ``fused_fft.inner_supported``."""
    axis = axis % st.ndim
    if axis >= st.ndim - 1:
        raise ValueError("fft_axis_fused serves leading axes only")
    return _FFTFused.apply(st, "inner", axis, bool(inverse), float(scale))


# ----------------------------------------------------------------------------
# The zero-padded minor axis in one pass (K9)
# ----------------------------------------------------------------------------

def pad_axis_ok(n_in: int, n_out: int, dtype, config: PlanConfig) -> bool:
    """Can a minor axis zero-padded from n_in to n_out run as one pass of
    K9 (``minor_fft.fft_minor_padded``) instead of a pad pass and a
    transform? tpufft's rule (``execute.py:761``) bounds n_out by its dense
    table; K9 takes every n_out inside K1's envelope."""
    return (config.backend != "xla" and 1 <= n_in < n_out
            and minor_fft.supported(n_out, dtype))


class _FFTPadded(torch.autograd.Function):
    """Differentiable zero-pad DFT of (batch, n_in) rows to length n: the
    backward is the opposite-sign length-n transform of g, cropped to
    n_in (the adjoint tpufft computes with the swapped rectangle)."""

    @staticmethod
    def forward(ctx, ar, ai, n, inverse, scale, config):
        ctx.args = (ar.shape[-1], n, inverse, scale, config)
        ctx.real_input = ai is None
        if ai is None:
            ai = torch.zeros_like(ar)
        return minor_fft.fft_minor_padded(ar.contiguous(), ai.contiguous(),
                                          n=n, inverse=inverse, scale=scale)

    @staticmethod
    def backward(ctx, gr, gi):
        n_in, n, inverse, scale, config = ctx.args
        br, bi = fft_axis(gr, gi, 1, default_bases(n, config.max_radix),
                          inverse=not inverse, scale=scale, config=config)
        return (br[:, :n_in], None if ctx.real_input else bi[:, :n_in],
                None, None, None, None)


def fft_axis_padded(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    n_out: int,
    *,
    inverse: bool,
    scale: float,
    config: PlanConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the minor ``axis`` to length ``n_out`` and transform it in
    one K9 pass (differentiable; the caller checks :func:`pad_axis_ok`).
    tpufft moves a non-minor axis minor for its rectangular kernel; the
    port pads a non-minor axis with a copy and runs the strided kernel."""
    if axis % ar.ndim != ar.ndim - 1:
        raise ValueError("fft_axis_padded serves the minor axis only")
    shape = ar.shape
    rows = (-1, shape[-1])
    outr, outi = _FFTPadded.apply(
        ar.reshape(rows), None if ai is None else ai.reshape(rows),
        int(n_out), bool(inverse), float(scale), config)
    out_shape = shape[:-1] + (int(n_out),)
    return outr.reshape(out_shape), outi.reshape(out_shape)


# ----------------------------------------------------------------------------
# Real transforms of one axis (K7, K8)
# ----------------------------------------------------------------------------

def r2c_minor_supported(n: int, dtype, config: PlanConfig) -> bool:
    """Can K7/K8 serve real length n in plane dtype ``dtype``? The port's
    own envelope (``real_fft.supported``: even n up to 32768, odd n inside
    K1's), not tpufft's n <= 1024 table bound."""
    return config.backend != "xla" and real_fft.supported(n, dtype)


@functools.lru_cache(maxsize=64)
def _c2r_weights(n: int):
    """c_k for the irfft gradient, for the real and the imaginary plane:
    1 at DC and (even n) Nyquist, 2 elsewhere; the imaginary weights are 0
    at DC and Nyquist, whose imaginary parts the forward ignores
    (tpufft's ``_tables_c2r``)."""
    m1 = n // 2 + 1
    cr = np.full(m1, 2.0)
    cr[0] = 1.0
    if n % 2 == 0:
        cr[-1] = 1.0
    ci = cr.copy()
    ci[0] = 0.0
    if n % 2 == 0:
        ci[-1] = 0.0
    return cr, ci


class _RFFTMinor(torch.autograd.Function):
    """Differentiable rfft of real (batch, n) rows on K7. The backward,
    gx = s Re(sum_k G[k] e^{+2 pi i j k / n}) with G zero-padded to n bins,
    is the opposite-sign transform of the padded gradient (K9 where it
    fits), real plane."""

    @staticmethod
    def forward(ctx, x, scale, config):
        ctx.args = (x.shape[-1], scale, config)
        return real_fft.rfft_minor(x.contiguous(), scale=scale)

    @staticmethod
    def backward(ctx, gr, gi):
        n, scale, config = ctx.args
        m1 = gr.shape[-1]
        if pad_axis_ok(m1, n, gr.dtype, config):
            br, _ = fft_axis_padded(gr, gi, 1, n, inverse=True, scale=scale,
                                    config=config)
        else:
            pad = (0, n - m1)
            br, _ = fft_axis(F.pad(gr, pad), F.pad(gi, pad), 1,
                             default_bases(n, config.max_radix),
                             inverse=True, scale=scale, config=config)
        return br, None, None


class _IRFFTMinor(torch.autograd.Function):
    """Differentiable irfft of (batch, n//2+1) rows to real (batch, n) on
    K8. The backward is gXr + i gXi = c_k s F(g)[k], F(g) the forward
    real transform of g on K7."""

    @staticmethod
    def forward(ctx, ar, ai, n, scale, config):
        ctx.args = (n, scale, config)
        return real_fft.irfft_minor(ar.contiguous(), ai.contiguous(), n=n,
                                    scale=scale)

    @staticmethod
    def backward(ctx, g):
        n, scale, config = ctx.args
        fr, fi = _RFFTMinor.apply(g, scale, config)
        cr, ci = (torch.as_tensor(c, dtype=fr.dtype, device=fr.device)
                  for c in _c2r_weights(n))
        return fr * cr, fi * ci, None, None, None


def rfft_minor(ar: torch.Tensor, axis: int, n: int, scale: float,
               config: PlanConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """rfft of length n along ``axis`` of the real plane ``ar`` on K7
    (differentiable; the caller checks :func:`r2c_minor_supported`):
    (re, im) planes packed to n//2+1. A non-minor axis is moved minor and
    back (tpufft ``execute.py:902-912``)."""
    axis = axis % ar.ndim
    moved = axis != ar.ndim - 1
    if moved:
        ar = ar.movedim(axis, -1)
    pre = ar.shape[:-1]
    outr, outi = _RFFTMinor.apply(ar.reshape(-1, n), float(scale), config)
    outr = outr.reshape(pre + (n // 2 + 1,))
    outi = outi.reshape(pre + (n // 2 + 1,))
    if moved:
        outr, outi = outr.movedim(-1, axis), outi.movedim(-1, axis)
    return outr, outi


def irfft_minor(ar: torch.Tensor, ai: torch.Tensor, axis: int, n: int,
                scale: float, config: PlanConfig) -> torch.Tensor:
    """irfft to length n along ``axis`` of the n//2+1-packed planes on K8
    (differentiable; the caller checks :func:`r2c_minor_supported`): the
    real plane. A non-minor axis is moved minor and back."""
    axis = axis % ar.ndim
    moved = axis != ar.ndim - 1
    if moved:
        ar, ai = ar.movedim(axis, -1), ai.movedim(axis, -1)
    pre = ar.shape[:-1]
    m1 = ar.shape[-1]
    out = _IRFFTMinor.apply(ar.reshape(-1, m1), ai.reshape(-1, m1), int(n),
                            float(scale), config)
    out = out.reshape(pre + (n,))
    return out.movedim(-1, axis) if moved else out
