"""Fourier-domain image filters (counterpart of ``tpufft/ndimage.py``;
scipy.ndimage semantics): ``fourier_gaussian``, ``fourier_uniform``,
``fourier_ellipsoid``, ``fourier_shift``.

They act on ALREADY-TRANSFORMED arrays: the caller computes ``fftn`` or
``rfftn``, multiplies by a filter's transfer function here, and transforms
back. The transfer functions are separable (gaussian, uniform, shift) or
radially symmetric (ellipsoid) host float64 constants: per-axis vectors
(the ellipsoid's full grid) broadcast-multiplied where the input lies.

Input forms: a tensor in gives a tensor out on its device (a real tensor
through ``fourier_shift`` gives a complex one), ``SplitComplex`` planes
give ``SplitComplex``, numpy gives numpy computed on the host (``output=``
is written for numpy input, as in tpufft).

Semantics (scipy.ndimage's): fourier_gaussian exp(-2 pi^2 s^2 f^2) per
axis; fourier_uniform sinc(size f), the CONTINUOUS box transform;
fourier_ellipsoid sinc / 2 J1(R)/R / 3 (sin R - R cos R)/R^3 for rank
1/2/3; fourier_shift exp(-2 pi i f shift); ``n >= 0`` marks ``axis`` as
the half spectrum of an rfft of a length-``n`` real array (frequencies
arange(m)/n there).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import SplitComplex

__all__ = ["fourier_gaussian", "fourier_uniform", "fourier_ellipsoid",
           "fourier_shift"]


def _per_axis(param, ndim: int, name: str) -> list[float]:
    if np.isscalar(param):
        return [float(param)] * ndim
    seq = [float(p) for p in param]
    if len(seq) != ndim:
        raise RuntimeError(f"{name} sequence length {len(seq)} does not "
                           f"match input rank {ndim}")
    return seq


def _axis_freqs(shape, n: int, axis: int) -> list[np.ndarray]:
    """Per-axis frequency grids (f64). ``n >= 0`` marks ``axis`` as the
    half-spectrum axis of an rfft of a length-``n`` real array."""
    axis = axis % len(shape)
    return [np.arange(m, dtype=np.float64) / max(n, 1)
            if j == axis and n >= 0 else np.fft.fftfreq(m)
            for j, m in enumerate(shape)]


def _bshape(v: np.ndarray, j: int, ndim: int) -> np.ndarray:
    shape = [1] * ndim
    shape[j] = v.shape[0]
    return v.reshape(shape)


def _shape(x) -> tuple:
    return tuple(x.re.shape) if isinstance(x, SplitComplex) \
        else tuple(np.shape(x))


def _on(h: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host f64 factor on ``like``'s device in its real dtype."""
    real = like.real.dtype if like.is_complex() else \
        like.dtype if like.is_floating_point() else torch.float32
    return torch.as_tensor(h, dtype=real, device=like.device)


def _apply_real(x, hs: list[np.ndarray], output=None):
    """Multiply by a separable REAL transfer function given as per-axis f64
    vectors; keeps the input's form."""
    if isinstance(x, SplitComplex):
        re, im = x.re, x.im
        for j, h in enumerate(hs):
            hj = _on(_bshape(h, j, re.ndim), re)
            re, im = re * hj, im * hj
        return SplitComplex(re, im)
    if isinstance(x, torch.Tensor):
        for j, h in enumerate(hs):
            x = x * _on(_bshape(h, j, x.ndim), x)
        return x
    a = np.asarray(x)
    y = a.astype(np.promote_types(a.dtype, np.float64), copy=True)
    for j, h in enumerate(hs):
        y *= _bshape(h, j, y.ndim)
    return _out(y.astype(np.promote_types(a.dtype, np.float32), copy=False),
                output)


def _apply_real_grid(x, H: np.ndarray, output=None):
    """Multiply by a full (non-separable) REAL f64 transfer grid."""
    if isinstance(x, SplitComplex):
        hj = _on(H, x.re)
        return SplitComplex(x.re * hj, x.im * hj)
    if isinstance(x, torch.Tensor):
        return x * _on(H, x)
    a = np.asarray(x)
    return _out((a * H).astype(np.promote_types(a.dtype, np.float32),
                               copy=False), output)


def _out(y: np.ndarray, output):
    if output is not None:
        output[...] = y
        return output
    return y


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1,
                     output=None):
    """Multiply a Fourier-transformed array by a Gaussian transfer function
    (scipy.ndimage.fourier_gaussian-compatible). ``sigma`` is the
    real-space standard deviation, scalar or per axis."""
    shape = _shape(input)
    sigmas = _per_axis(sigma, len(shape), "sigma")
    hs = [np.exp(-2.0 * np.pi ** 2 * s * s * f * f)
          for s, f in zip(sigmas, _axis_freqs(shape, n, axis))]
    return _apply_real(input, hs, output)


def fourier_uniform(input, size, n: int = -1, axis: int = -1, output=None):
    """Multiply a Fourier-transformed array by the transfer function of a
    (continuous) box of the given size, sinc(size * f) per axis
    (scipy.ndimage.fourier_uniform-compatible)."""
    shape = _shape(input)
    sizes = _per_axis(size, len(shape), "size")
    hs = [np.sinc(s * f) for s, f in zip(sizes, _axis_freqs(shape, n, axis))]
    return _apply_real(input, hs, output)


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1,
                      output=None):
    """Multiply a Fourier-transformed array by the transfer function of an
    ellipsoid of the given size (scipy.ndimage.fourier_ellipsoid-
    compatible; rank 1-3 only, like scipy): sinc for rank 1, the circular
    aperture 2 J1(R)/R for rank 2, the sphere 3 (sin R - R cos R)/R^3 for
    rank 3, with R = pi |size .* f|."""
    shape = _shape(input)
    ndim = len(shape)
    if ndim > 3:
        raise NotImplementedError(
            "fourier_ellipsoid only supports rank 1-3 input (scipy parity)")
    sizes = _per_axis(size, ndim, "size")
    freqs = _axis_freqs(shape, n, axis)
    if ndim == 1:
        return _apply_real(input, [np.sinc(sizes[0] * freqs[0])], output)
    R2 = np.zeros((1,) * ndim, np.float64)
    for j, (s, f) in enumerate(zip(sizes, freqs)):
        R2 = R2 + _bshape((s * f) ** 2, j, ndim)
    R = np.pi * np.sqrt(R2)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ndim == 2:
            from scipy.special import j1
            H = np.where(R == 0.0, 1.0, 2.0 * j1(R) / R)
        else:
            H = np.where(R == 0.0, 1.0,
                         3.0 * (np.sin(R) - R * np.cos(R)) / R ** 3)
    return _apply_real_grid(input, H, output)


def fourier_shift(input, shift, n: int = -1, axis: int = -1, output=None):
    """Multiply a Fourier-transformed array by the phase ramp
    exp(-2 pi i f . shift), a real-space translation
    (scipy.ndimage.fourier_shift-compatible). The transfer function is
    complex: numpy input promotes to complex, a real tensor gives a
    complex tensor, ``SplitComplex`` stays ``SplitComplex``."""
    shape = _shape(input)
    ndim = len(shape)
    shifts = _per_axis(shift, ndim, "shift")
    freqs = _axis_freqs(shape, n, axis)
    if isinstance(input, SplitComplex):
        re, im = input.re, input.im
        for j, (s, f) in enumerate(zip(shifts, freqs)):
            hr = _on(_bshape(np.cos(2 * np.pi * s * f), j, ndim), re)
            hi = _on(_bshape(np.sin(-2 * np.pi * s * f), j, ndim), re)
            re, im = re * hr - im * hi, re * hi + im * hr
        return SplitComplex(re, im)
    if isinstance(input, torch.Tensor):
        y = input if input.is_complex() else torch.complex(
            input, torch.zeros_like(input))
        for j, (s, f) in enumerate(zip(shifts, freqs)):
            y = y * torch.as_tensor(
                _bshape(np.exp(-2j * np.pi * s * f), j, ndim),
                dtype=y.dtype, device=y.device)
        return y
    a = np.asarray(input)
    y = a.astype(np.promote_types(a.dtype, np.complex128), copy=True)
    for j, (s, f) in enumerate(zip(shifts, freqs)):
        y *= _bshape(np.exp(-2j * np.pi * s * f), j, ndim)
    return _out(y.astype(np.promote_types(a.dtype, np.complex64),
                         copy=False), output)
