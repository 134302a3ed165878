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
  runs the two-pass split (:func:`_fft_axis_two_pass`);
* a length with a prime factor above 1024 (any length under
  ``backend="pallas"``) runs Bluestein (:func:`_fft_axis_bluestein`),
  whose two padded transforms come back through this ladder;
* anything else (float64, ``backend="xla"``, what is left) runs the
  torch-op Stockham of ``core.py`` on the planes' device, bf16 planes
  widened to f32 around it; ``backend="pallas"`` raises there instead.

Every wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. :func:`fft_pair_last` runs a plan's two trailing
axes in one pass of the pair kernel (``kernels/pair_fft``) when
:func:`pair_supported` says it fits.

``fft_axis`` and ``fft_pair_last`` are differentiable (``_FFTAxis``,
``_FFTPair``): the split-plane DFT is the real-linear map
[[Fr, -Fi], [Fi, Fr]] with F symmetric, so its transpose applied to g is
the same transform with the opposite sign and the same scale.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import core
from .config import PlanConfig
from .kernels import inner_fft, minor_fft, pair_fft
from .planner import factorize, next_fast_len

__all__ = ["fft_axis", "fft_pair_last", "pair_supported"]

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

@functools.lru_cache(maxsize=None)
def _split_large(n: int):
    """Factor n into a * b with both factors inside the kernels' envelope,
    a >= b and as balanced as possible; None if there is no such split."""
    if n < 4:
        return None
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
                       scale: float):
    """Four-step split of a length n = a*b beyond the single-pass envelope.

    With the flat index i = ia*b + ib along the axis, viewing it as (a, b)
    is free. Pass 1 transforms ia on the strided kernel (K3) with the
    inter-factor twiddle T[ka, ib] applied at its store; pass 2 transforms
    ib on the kernel its layout picks (K1 when the axis is minor); one
    transpose copy swaps the digits (ka, kb) -> k = kb*a + ka into natural
    order. Unlike tpufft, no axis-to-front transposes are needed: those
    exist for the TPU's lane layout."""
    if ai is None:
        ai = torch.zeros_like(ar)
    shape = ar.shape
    pre = math.prod(shape[:axis])
    post = math.prod(shape[axis + 1:])
    view = (pre * a, b, post)
    tw = _device_two_pass_twiddle(a, b, bool(inverse), ar.device)
    yr, yi = inner_fft.fft_inner_nd(
        ar.reshape(view).contiguous(), ai.reshape(view).contiguous(), n=a,
        inverse=inverse, scale=1.0, twiddle=tw)
    yr, yi = _kernel_axis(yr, yi, 1, inverse=inverse, scale=scale)
    split = (pre, a, b, post)
    outr = yr.reshape(split).transpose(1, 2).reshape(shape)
    outi = yi.reshape(split).transpose(1, 2).reshape(shape)
    return outr, outi


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


def _pair_impl(ar, ai, *, inverse: bool, scale: float):
    if ai is None:
        ai = torch.zeros_like(ar)
    shape = ar.shape
    view = (-1,) + tuple(shape[-2:])
    outr, outi = pair_fft.fft_pair(
        ar.reshape(view).contiguous(), ai.reshape(view).contiguous(),
        inverse=inverse, scale=scale)
    return outr.reshape(shape), outi.reshape(shape)


class _FFTPair(torch.autograd.Function):
    """Differentiable trailing-pair transform (tpufft's ``_fft_pair_diff``):
    the backward is the pair transform of the opposite sign with the same
    scale."""

    @staticmethod
    def forward(ctx, ar, ai, inverse, scale):
        ctx.args = (inverse, scale)
        ctx.real_input = ai is None
        return _pair_impl(ar, ai, inverse=inverse, scale=scale)

    @staticmethod
    def backward(ctx, gr, gi):
        inverse, scale = ctx.args
        br, bi = _FFTPair.apply(gr, gi, not inverse, scale)
        return br, (None if ctx.real_input else bi), None, None


def fft_pair_last(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    *,
    inverse: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the last two axes in one pass of the pair kernel
    (differentiable); the caller checks :func:`pair_supported`."""
    return _FFTPair.apply(ar, ai, bool(inverse), float(scale))
