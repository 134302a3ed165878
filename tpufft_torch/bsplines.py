"""B-spline filters (counterpart of ``tpufft/bsplines.py``; scipy.signal
semantics): ``gauss_spline``, the spline prefilters ``cspline1d``,
``qspline1d``, ``cspline2d``, ``qspline2d``, their evaluation
``cspline1d_eval``/``qspline1d_eval``, ``sepfir2d``, ``spline_filter`` and
the symmetric IIR filters ``symiirorder1``/``symiirorder2``.

As in tpufft, every prefilter is the exact solve of its banded system, the
half-sample mirror boundary folded into the band (no truncated startup sums:
``precision`` is accepted and ignored). The LU factors (no pivoting; the
systems are diagonally dominant) are host float64 and converge
geometrically away from the two ends, so the factors of an N-row system
are three pieces: head rows, one steady row, tail rows. They are read from
the factors of a short system with the same two ends (``_factors``), so a
long signal costs no long host factorization.

Each substitution runs where the signal lies, along the last axis of a
(B, N) tensor, columns batched as B:

* the head rows, where the multipliers still change, are a host-built
  inverse of their unit-lower-triangular block, applied as one float64
  (complex128) product;
* the steady interior is the constant-coefficient recurrence
  y[i] = c[i] - sum_d m_d y[i - d] of order p (1 for the interpolating
  splines and ``symiirorder1``, 2 for the smoothing cubic spline and
  ``symiirorder2``): ``iir._affine_scan`` in companion form, seeded with the
  head's last p values;
* the tail rows, like the head, seeded with the interior's last p values.

The back substitution is the same forward shape on the flipped rows. The
2-D prefilters are one solve along each axis. The scan's S x S algebra is
written out as sums of host constants (``iir._affine_scan``) and the small
products run in float64, so TF32 never touches a recurrence.

Input forms: a tensor runs where it lies and keeps float32, float64,
complex64 or complex128 (other dtypes compute in float32); numpy input runs
on ``device`` (None: the CUDA device, ``api.numpy_device``) in float64, as
tpufft computes it, and comes back as numpy. The evaluations place their
points in float64 whatever the coefficients' dtype.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .api import compute_tensor, numpy_device
from .iir import _affine_scan

__all__ = ["gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval",
           "qspline1d_eval", "cspline2d", "qspline2d", "spline_filter",
           "sepfir2d", "symiirorder1", "symiirorder2"]

# the longest system whose factors are cached (tpufft's limit)
_CACHED_N = 65536
# the first short system tried for the factors of a longer one
_SHORT_N = 512
# factor rows this close to the steady row (relative, entry by entry) are
# steady: near poles of modulus ~0.9 and up the elimination never settles
# exactly but jitters about its fixed point (by 3e-13 at r = 0.97)
_STEADY_RTOL = 1e-12


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _placed(x, device, dtype=np.float64):
    """(x as the tensor to compute on, whether it came as numpy): a tensor
    stays where it lies, numpy is cast to ``dtype`` and sent to
    ``numpy_device(device)``."""
    if isinstance(x, torch.Tensor):
        return compute_tensor(x)
    xn = np.ascontiguousarray(np.asarray(x, dtype))
    return torch.from_numpy(xn).to(numpy_device(device)), True


def _returned(t: torch.Tensor, as_numpy: bool):
    return _numpy(t) if as_numpy else t


def gauss_spline(x, n: int, *, device=None):
    """Gaussian approximation of an order-n B-spline
    (scipy.signal.gauss_spline-compatible): variance (n + 1) / 12."""
    t, as_numpy = _placed(x, device)
    var = (n + 1) / 12.0
    out = torch.exp(-t ** 2 / (2 * var)) / math.sqrt(2 * math.pi * var)
    return _returned(out, as_numpy)


# ---------------------------------------------------------------------------
# Host factors of the folded band


def _folded_band(taps: dict, N: int, dtype) -> tuple[np.ndarray, int]:
    """A[n, p + d] = entry (n, n + d) of the N x N matrix with ``taps[d]``
    at column n + d, out-of-range columns folded by the half-sample mirror
    x[-1-k] = x[k], x[N+k] = x[N-1-k]."""
    p = max(abs(d) for d in taps)
    A = np.zeros((N, 2 * p + 1), dtype)
    for d, v in taps.items():
        A[:, p + d] = v
    for n in sorted(set(range(min(p, N))) | set(range(max(N - p, 0), N))):
        A[n] = 0.0
        for d, v in taps.items():
            j = n + d
            while not 0 <= j < N:
                j = -j - 1 if j < 0 else 2 * N - 1 - j
            if abs(j - n) > p:
                raise ValueError("mirror fold escapes the band "
                                 "(signal shorter than the filter)")
            A[n, p + j - n] += v
    return A, p


def _eliminate(A: np.ndarray, L: np.ndarray, p: int, k: int,
               first_row: int) -> None:
    """Elimination step k on rows max(k + 1, first_row) .. k + p: their
    multipliers into L, row k's multiples out of A."""
    N = A.shape[0]
    for i in range(max(k + 1, first_row), min(k + p, N - 1) + 1):
        di = i - k
        m = A[i, p - di] / A[k, p]
        L[i, di - 1] = m
        A[i, p - di + 1:2 * p - di + 1] -= m * A[k, p + 1:]
        A[i, p - di] = 0.0


@functools.lru_cache(maxsize=64)
def _band_lu(taps_items: tuple, N: int, complex_: bool):
    """(A, L, p): the upper band and the multipliers of the LU factors of
    the folded N x N system (no pivoting). Once two successive rows come
    out equal the factors have reached their fixed point: the interior is
    filled with that row and elimination resumes a margin above the
    bottom, where the lower fold perturbs the band again."""
    A, p = _folded_band(dict(taps_items),
                        N, np.complex128 if complex_ else np.float64)
    L = np.zeros((N, p), A.dtype)
    margin = 2 * p + 4
    repeats = 0
    for k in range(N - 1):
        _eliminate(A, L, p, k, 0)
        if k < 1 or k + 1 >= N - margin:
            continue
        same = np.array_equal(A[k + 1], A[k]) and \
            np.array_equal(L[k + 1], L[k])
        repeats = repeats + 1 if same else 0
        if repeats == 2:
            fill = N - margin
            A[k + 2:fill] = A[k + 1]
            L[k + 2:fill] = L[k + 1]
            # steps up to k reached every row already: resume after them,
            # updating only the rows below the filled interior
            for kk in range(max(fill - p, k + 1), N - 1):
                _eliminate(A, L, p, kk, fill)
            break
    return A, L, p


def _varying_rows(M: np.ndarray) -> tuple[int, int]:
    """(head, tail): how many rows of M come before and after the run of
    rows around the middle that stay within ``_STEADY_RTOL`` of the middle
    row."""
    N = M.shape[0]
    mid = M[N // 2]
    differs = np.any(np.abs(M - mid) > _STEADY_RTOL * np.abs(mid), axis=1)
    before = np.nonzero(differs[:N // 2])[0]
    after = np.nonzero(differs[N // 2:])[0]
    head = int(before[-1]) + 1 if before.size else 0
    tail = N - N // 2 - int(after[0]) if after.size else 0
    return head, tail


class _Stage(NamedTuple):
    """One substitution y[i] = c[i] - sum_d C[i, d-1] y[i-d] over N rows:
    ``head`` (H, H) maps the first H values of c to y's; ``tail``
    (T, T + p) maps the last T values of c and the p values before them
    (latest first) to y's; between them the steady coefficients ``steady``
    (p,) hold."""
    head: np.ndarray
    steady: np.ndarray
    tail: np.ndarray


def _stage(rows: np.ndarray, head: int, tail: int, steady) -> _Stage:
    """The stage of coefficient rows ``rows`` (head rows then tail rows)."""
    p = rows.shape[1]
    W = np.zeros((head, head), rows.dtype)
    for i in range(head):
        W[i, i] = 1.0
        for d in range(1, min(p, i) + 1):
            W[i] -= rows[i, d - 1] * W[i - d]
    V = np.zeros((tail, tail + p), rows.dtype)
    for i in range(tail):
        V[i, i] = 1.0
        for d in range(1, p + 1):
            prev = V[i - d] if d <= i else \
                np.eye(1, tail + p, tail + d - i - 1, rows.dtype)[0]
            V[i] -= rows[head + i, d - 1] * prev
    return _Stage(W, np.asarray(steady), V)


class _Factors(NamedTuple):
    """The solve of a folded N-row system: the forward substitution, the
    diagonal (head, steady, tail values), and the back substitution as a
    forward one on the flipped rows."""
    lower: _Stage
    diag: tuple
    upper: _Stage


@functools.lru_cache(maxsize=64)
def _factors(taps_items: tuple, N: int, complex_: bool) -> _Factors:
    n = N
    if N > _SHORT_N:
        # the factors of a short system with the same two ends, once its
        # interior has converged: the same head rows, steady row and tail
        # rows as the N-row system's
        n = _SHORT_N
        while n < N:
            factor = _band_lu if n <= _CACHED_N else _band_lu.__wrapped__
            A, L, p = factor(taps_items, n, complex_)
            h, t = _varying_rows(np.hstack([L, A]))
            if h + t <= n - 2 * p - 4:
                break
            n = min(2 * n, N)
    factor = _band_lu if n <= _CACHED_N else _band_lu.__wrapped__
    A, L, p = factor(taps_items, n, complex_)
    h, t = _varying_rows(np.hstack([L, A]))
    H = min(max(h, p), N)
    T = min(max(t, p), N - H)
    mid = n // 2
    diag = A[:, p]
    upper = A[:, p + 1:] / diag[:, None]
    lower = _stage(np.vstack([L[:H], L[n - T:]]), H, T, L[mid])
    # the back substitution runs on flipped rows: its head is the tail
    flipped = np.vstack([upper[n - T:][::-1], upper[:H][::-1]])
    return _Factors(lower, (diag[:H], diag[mid], diag[n - T:]),
                    _stage(flipped, T, H, upper[mid]))


# ---------------------------------------------------------------------------
# Substitutions on the device


def _wide(t: torch.Tensor) -> torch.dtype:
    return torch.complex128 if t.is_complex() else torch.float64


def _product(v: torch.Tensor, W: np.ndarray) -> torch.Tensor:
    """v (B, k) times W.T, in float64 (complex128), back in v's dtype."""
    hi = _wide(v)
    Wt = torch.as_tensor(W.T, dtype=hi, device=v.device)
    return (v.to(hi) @ Wt).to(v.dtype)


def _substitute(y: torch.Tensor, stage: _Stage) -> torch.Tensor:
    """The stage's forward substitution along the last axis of y (B, N)."""
    N = y.shape[1]
    H, T = stage.head.shape[0], stage.tail.shape[0]
    p = stage.steady.shape[0]
    parts = [_product(y[:, :H], stage.head)]
    if N - H - T:
        M = np.zeros((p, p), stage.steady.dtype)
        M[0] = -stage.steady
        M[np.arange(1, p), np.arange(p - 1)] = 1.0
        c = y[:, H:N - T]
        z = _affine_scan([c] + [torch.zeros_like(c)] * (p - 1),
                         [parts[0][:, H - 1 - j] for j in range(p)], M)
        parts.append(z[0])
    done = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    if not T:
        return done
    # the p values before the tail, latest first; in a system shorter than
    # p + T the missing ones meet zero coefficients
    before = F.pad(done[:, -p:], (max(0, p - done.shape[1]), 0)).flip(1)
    tail = _product(torch.cat([y[:, N - T:], before], 1), stage.tail)
    return torch.cat([done, tail], 1)


def _solve(taps: dict, y: torch.Tensor) -> torch.Tensor:
    """The folded banded system solved along the last axis of y (B, N)."""
    N = y.shape[1]
    if N == 0:
        raise ValueError("cannot solve an empty signal")
    complex_ = y.is_complex() or any(isinstance(v, complex)
                                     for v in taps.values())
    if complex_ and not y.is_complex():
        y = y.to(torch.complex128 if y.dtype == torch.float64
                 else torch.complex64)
    f = _factors(tuple(sorted(taps.items())), N, complex_)
    y = _substitute(y, f.lower)
    head, steady, tail = f.diag
    diag = torch.full((N,), complex(steady) if complex_ else float(steady),
                      dtype=y.dtype, device=y.device)
    diag[:head.size] = torch.as_tensor(head, dtype=y.dtype, device=y.device)
    diag[N - tail.size:] = torch.as_tensor(tail, dtype=y.dtype,
                                           device=y.device)
    y = (y / diag).flip(1)
    return _substitute(y, f.upper).flip(1)


def _image(x, device):
    t, as_numpy = _placed(x, device)
    if t.ndim != 2:
        raise ValueError("input must be 2-D")
    return t, as_numpy


# ---------------------------------------------------------------------------
# Symmetric IIR filters


def symiirorder1(signal, c0, z1, precision=-1.0, *, device=None):
    """Zero-phase IIR ``c0 / ((1 - z1 z^-1)(1 - z1 z))`` under the mirror-
    symmetric boundary (scipy.signal.symiirorder1-compatible; solved
    exactly, ``precision`` accepted and ignored). Complex ``c0``/``z1``
    give a complex result."""
    cplx = isinstance(z1, complex) or isinstance(c0, complex) or (
        not isinstance(signal, torch.Tensor) and np.iscomplexobj(signal))
    x, as_numpy = _placed(signal, device,
                          np.complex128 if cplx else np.float64)
    if x.ndim != 1:
        raise ValueError("signal must be 1-D")
    if abs(z1) >= 1:
        raise ValueError("|z1| must be less than 1.0")
    off = -z1 / c0
    out = _solve({0: (1 + z1 * z1) / c0, -1: off, 1: off}, x[None])[0]
    return _returned(out, as_numpy)


def symiirorder2(input, r, omega, precision=-1.0, *, device=None):
    """Zero-phase IIR ``cs^2 / (A(z) A(1/z))`` with
    ``A(z) = 1 - 2 r cos(omega) z^-1 + r^2 z^-2`` and
    ``cs = 1 - 2 r cos(omega) + r^2``, mirror-symmetric boundary
    (scipy.signal.symiirorder2-compatible up to scipy's startup
    truncation: this solve is exact; ``precision`` ignored)."""
    x, as_numpy = _placed(input, device)
    if x.ndim != 1:
        raise ValueError("input must be 1-D")
    r = float(r)
    if not 0 <= r < 1:
        raise ValueError("r must be in [0, 1)")
    return _returned(_solve(_order2_taps(r, omega), x[None])[0], as_numpy)


def _order2_taps(r: float, omega: float) -> dict:
    """The taps of A(z) A(1/z) / cs^2 (``symiirorder2``)."""
    a = (1.0, -2 * r * math.cos(omega), r * r)
    cs2 = (1 - 2 * r * math.cos(omega) + r * r) ** 2
    return {d: sum(a[i] * a[i - d] for i in range(max(d, 0),
                                                 min(3, 3 + d))) / cs2
            for d in range(-2, 3)}


# ---------------------------------------------------------------------------
# Spline coefficient prefilters


def _spline_taps(kind: str, lamb: float) -> dict:
    """The prefilter's taps: the B-spline kernel sampled at the knots,
    plus ``lamb`` times the second-difference penalty D2^T D2 for the
    smoothing cubic spline (Unser 1993, part II)."""
    side, centre = (1 / 6.0, 4 / 6.0) if kind == "cubic" else \
        (1 / 8.0, 6 / 8.0)
    taps = {-1: side, 0: centre, 1: side}
    if lamb == 0.0:
        return taps
    penalty = {-2: 1.0, -1: -4.0, 0: 6.0, 1: -4.0, 2: 1.0}
    return {d: taps.get(d, 0.0) + lamb * v for d, v in penalty.items()}


def cspline1d(signal, lamb: float = 0.0, *, device=None):
    """Cubic B-spline coefficients of a 1-D signal
    (scipy.signal.cspline1d-compatible): the exact solve of
    ``(c[n-1] + 4 c[n] + c[n+1]) / 6 = x[n]`` (lamb = 0) or of the
    smoothing spline's normal equations (lamb > 0), mirror-symmetric
    boundary."""
    x, as_numpy = _placed(signal, device)
    if x.ndim != 1:
        raise ValueError("signal must be 1-D")
    out = _solve(_spline_taps("cubic", float(lamb)), x[None])[0]
    return _returned(out, as_numpy)


def _no_smoothing(lamb) -> None:
    if lamb != 0.0:
        raise ValueError("smoothing quadratic splines are not "
                         "supported (lamb must be 0)")


def qspline1d(signal, lamb: float = 0.0, *, device=None):
    """Quadratic B-spline coefficients (scipy.signal.qspline1d-compatible;
    as in scipy, only lamb = 0 is defined for the quadratic family)."""
    _no_smoothing(lamb)
    x, as_numpy = _placed(signal, device)
    if x.ndim != 1:
        raise ValueError("signal must be 1-D")
    return _returned(_solve(_spline_taps("quad", 0.0), x[None])[0],
                     as_numpy)


def _solve_2d(taps: dict, im: torch.Tensor) -> torch.Tensor:
    """The separable prefilter: one solve along axis 0 (the image's columns
    batched), then one along axis 1 (its rows batched)."""
    return _solve(taps, _solve(taps, im.T).T)


def cspline2d(input, lamb: float = 0.0, precision=-1.0, *, device=None):
    """Cubic spline coefficients of a 2-D array: the per-axis prefilter
    (scipy.signal.cspline2d-compatible; exact solve, ``precision``
    ignored)."""
    im, as_numpy = _image(input, device)
    return _returned(_solve_2d(_spline_taps("cubic", float(lamb)), im),
                     as_numpy)


def qspline2d(input, lamb: float = 0.0, precision=-1.0, *, device=None):
    """Quadratic spline coefficients of a 2-D array
    (scipy.signal.qspline2d-compatible)."""
    _no_smoothing(lamb)
    im, as_numpy = _image(input, device)
    return _returned(_solve_2d(_spline_taps("quad", 0.0), im), as_numpy)


# ---------------------------------------------------------------------------
# Evaluation and separable FIR


def _bspline3(u: torch.Tensor) -> torch.Tensor:
    au = u.abs()
    return torch.where(au < 1, 2 / 3.0 - au * au * (1 - au / 2.0),
                       torch.where(au < 2, (2 - au) ** 3 / 6.0, 0.0))


def _bspline2(u: torch.Tensor) -> torch.Tensor:
    au = u.abs()
    return torch.where(au < 0.5, 0.75 - au * au,
                       torch.where(au < 1.5, (au - 1.5) ** 2 / 2.0, 0.0))


def _spline_eval(cj, newx, dx: float, x0: float, basis, device):
    """sum_k c[k] basis(t - k) at t = (newx - x0) / dx, in float64.

    Two mirror rules, as scipy's evaluation has them (tpufft found them
    against scipy 1.17): the points fold by the whole-sample rule about 0
    and N - 1 (period 2 (N - 1)), the coefficient index by the half-sample
    rule c[-1] = c[0], c[N] = c[N - 1] (period 2 N)."""
    c, as_numpy = _placed(cj, device)
    dev = c.device
    pts = newx.to(dev, torch.float64) if isinstance(newx, torch.Tensor) \
        else torch.as_tensor(np.asarray(newx, np.float64), device=dev)
    N = c.shape[0]
    t = (pts - x0) / float(dx)
    if N > 1:
        t = torch.fmod(t.abs(), 2 * (N - 1))
        t = torch.where(t > N - 1, 2 * (N - 1) - t, t)
    else:
        t = torch.zeros_like(t)
    first = torch.floor(t).long() - 2
    c64 = c.to(_wide(c))
    out = torch.zeros(t.shape, dtype=c64.dtype, device=dev)
    for j in range(5):
        k = first + j
        fold = torch.remainder(k, 2 * N)
        fold = torch.where(fold >= N, 2 * N - 1 - fold, fold)
        out += c64[fold] * basis(t - k)
    return _returned(out.to(c.dtype), as_numpy)


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0, *,
                   device=None):
    """Evaluate a cubic spline from its coefficients at ``newx``
    (scipy.signal.cspline1d_eval-compatible: points outside the knot
    range mirror back in). The result has the coefficients' dtype."""
    return _spline_eval(cj, newx, dx, x0, _bspline3, device)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0, *,
                   device=None):
    """Evaluate a quadratic spline from its coefficients
    (scipy.signal.qspline1d_eval-compatible)."""
    return _spline_eval(cj, newx, dx, x0, _bspline2, device)


def _taps(h) -> np.ndarray:
    return np.asarray(_numpy(h) if isinstance(h, torch.Tensor) else h,
                      np.float64)


def _fir_axis(im: torch.Tensor, h: np.ndarray, axis: int) -> torch.Tensor:
    """np.convolve(v, h, "valid") of each line along ``axis`` after a
    half-sample mirror pad of len(h) // 2 (np.pad's "symmetric"), as
    shifted sums on the image's device."""
    if h.size == 1:
        return im * float(h[0])
    n, p = im.shape[axis], h.size // 2
    k = torch.remainder(torch.arange(-p, n + p, device=im.device), 2 * n)
    ext = im.index_select(axis, torch.where(k >= n, 2 * n - 1 - k, k))
    out = ext.narrow(axis, 0, n) * float(h[-1])
    for j in range(1, h.size):
        out.add_(ext.narrow(axis, j, n), alpha=float(h[-1 - j]))
    return out


def sepfir2d(input, hrow, hcol, *, device=None):
    """Separable 2-D FIR filter with the mirror-symmetric boundary
    (scipy.signal.sepfir2d-compatible; odd-length kernels): ``hcol``
    along axis 0, then ``hrow`` along axis 1."""
    im, as_numpy = _image(input, device)
    hrow, hcol = _taps(hrow), _taps(hcol)
    if hrow.ndim != 1 or hcol.ndim != 1 or \
            hrow.size % 2 != 1 or hcol.size % 2 != 1:
        raise ValueError("hrow and hcol must be 1-D with odd length")
    return _returned(_fir_axis(_fir_axis(im, hcol, 0), hrow, 1), as_numpy)


def spline_filter(Iin, lmbda: float = 5.0, *, device=None):
    """Smoothing spline image filter (scipy.signal.spline_filter-
    compatible): smoothing cubic coefficients, then the B3 reconstruction
    kernel [1, 4, 1] / 6 along both axes. Unlike scipy's recursion, which
    fails to converge at lmbda = 5, the exact solve always delivers."""
    im, as_numpy = _image(Iin, device)
    coeffs = _solve_2d(_spline_taps("cubic", float(lmbda)), im)
    h = np.array([1.0, 4.0, 1.0]) / 6.0
    return _returned(_fir_axis(_fir_axis(coeffs, h, 0), h, 1), as_numpy)
