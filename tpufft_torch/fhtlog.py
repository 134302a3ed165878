"""Fast Hankel transform (FFTLog) on the port's real-FFT path (counterpart
of ``tpufft/fhtlog.py``; scipy.fft.fht / ifht / fhtoffset semantics).

Talman (1978) / Hamilton (2000) FFTLog:

    A = flip(irfft(u * rfft(a)))        (forward; the inverse divides by u*)

The u-coefficients are loggamma-based and computed on the host in
float64 with ``scipy.special``, cached as numpy planes; the rfft and irfft
run through ``api.rfft``/``api.irfft``, so f32 rows of a length inside
K7/K8's envelope run one K7 pass, the diagonal multiply and one K8 pass.

Input: a real numpy array (numpy out, computed on ``device``: the CUDA
device unless the caller names another) or a real tensor (a tensor out on
its device); float64 input stays float64. ``SplitComplex`` is not
accepted: the transform is real to real. Differentiable through the
transforms.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from . import api
from .api import numpy_device

_LN2 = math.log(2.0)

__all__ = ["fht", "ifht", "fhtoffset"]


@functools.lru_cache(maxsize=64)
def _fht_coeff_cached(n: int, dln: float, mu: float, offset: float,
                      bias: float, inverse: bool):
    """FFTLog u-coefficients as (re, im) float64 numpy planes, and whether
    the transform is singular.

    u_m = (k_c r_c)^{-2pi i m/(n dln)} U_mu(q + 2pi i m/(n dln)),
    U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2)  (m = 0..n//2).
    """
    from scipy.special import loggamma, poch

    lnkr, q = offset, bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    # log u = q ln2 + loggamma(xp + iy) - loggamma(xm - iy) + 2iy(ln2 - lnkr)
    v = loggamma(xp + 1j * y) - loggamma(xm - 1j * y)
    u = np.exp(v.real + _LN2 * q
               + 1j * (v.imag + 2 * (_LN2 - lnkr) * y))
    if n % 2 == 0:
        u.imag[-1] = 0.0  # the Nyquist coefficient of a real transform
    if not np.isfinite(u[0]):
        # the poles of the two loggammas cancel at m=0; poch() evaluates
        # the ratio Gamma(xp)/Gamma(xm) = poch(xm, xp - xm) through them
        u[0] = 2**q * poch(xm, xp - xm)
    singular = False
    if np.isinf(u[0].real) and not inverse:
        singular = True
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        singular = True
        u[0] = np.inf
    return (np.ascontiguousarray(u.real), np.ascontiguousarray(u.imag),
            singular)


def _fht_coeff(n, dln, mu, offset, bias, inverse):
    ur, ui, singular = _fht_coeff_cached(n, dln, mu, offset, bias, inverse)
    if singular:  # warn on every call, like scipy (the table is cached)
        kind = ("singular inverse transform" if inverse
                else "singular transform")
        warnings.warn(f"{kind}; consider changing the bias", stacklevel=3)
    return ur, ui


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Offset near ``initial`` satisfying Hamilton's low-ringing condition
    (scipy.fft.fhtoffset-compatible)."""
    from scipy.special import loggamma

    lnkr, q = float(initial), float(bias)
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * dln)
    zp = loggamma(xp + 1j * y)
    zm = loggamma(xm + 1j * y)
    arg = (_LN2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)


def _weights(ur, ui, inverse: bool) -> np.ndarray:
    """The diagonal as complex128: u, or 1/conj(u) = u / |u|^2 for the
    inverse, with the intentional inf of a singular inverse mapped to 0."""
    if not inverse:
        return ur + 1j * ui
    den = ur * ur + ui * ui
    with np.errstate(invalid="ignore"):
        wr = np.where(np.isfinite(den), ur / den, 0.0)
        wi = np.where(np.isfinite(den), ui / den, 0.0)
    return wr + 1j * wi


def _fhtq(a: torch.Tensor, n: int, w: np.ndarray, config) -> torch.Tensor:
    spec = api.rfft(a, axis=-1, config=config)
    spec = spec * torch.as_tensor(w, dtype=spec.dtype, device=spec.device)
    out = api.irfft(spec, n=n, axis=-1, config=config)
    return torch.flip(out, dims=(-1,))


def _bias_factors(n: int, dln: float, bias: float, offset: float):
    j = np.arange(n) - (n - 1) / 2
    pre = np.exp(-bias * j * dln)
    post = np.exp(-bias * (j * dln + offset))
    return pre, post


def _real_tensor(a, device) -> tuple[torch.Tensor, bool]:
    """``a`` as a real tensor, and whether it came as numpy."""
    if isinstance(a, torch.Tensor):
        t, is_np = a, False
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(
            numpy_device(device))
        is_np = True
    if t.is_complex():
        raise TypeError("fht/ifht take real input, got a complex array")
    if not t.is_floating_point():
        t = t.to(torch.float64 if is_np else torch.float32)
    return t, is_np


def _scaled(t: torch.Tensor, factor: np.ndarray) -> torch.Tensor:
    return t * torch.as_tensor(factor, dtype=t.dtype, device=t.device)


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
        *, config=None, device=None):
    """Discrete Hankel transform of a log-spaced periodic sequence
    (scipy.fft.fht-compatible; last axis)."""
    dln, mu, offset, bias = map(float, (dln, mu, offset, bias))
    t, is_np = _real_tensor(a, device)
    n = int(t.shape[-1])
    if bias != 0:
        pre, post = _bias_factors(n, dln, bias, offset)
        t = _scaled(t, pre)
    ur, ui = _fht_coeff(n, dln, mu, offset, bias, False)
    out = _fhtq(t, n, _weights(ur, ui, False), config)
    if bias != 0:
        out = _scaled(out, post)
    return out.detach().cpu().numpy() if is_np else out


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
         *, config=None, device=None):
    """Inverse of :func:`fht` (scipy.fft.ifht-compatible; last axis)."""
    dln, mu, offset, bias = map(float, (dln, mu, offset, bias))
    t, is_np = _real_tensor(A, device)
    n = int(t.shape[-1])
    if bias != 0:
        pre, post = _bias_factors(n, dln, bias, offset)
        t = _scaled(t, 1.0 / post)
    ur, ui = _fht_coeff(n, dln, mu, offset, bias, True)
    out = _fhtq(t, n, _weights(ur, ui, True), config)
    if bias != 0:
        out = _scaled(out, 1.0 / pre)
    return out.detach().cpu().numpy() if is_np else out
