"""Window functions (counterpart of ``tpufft/windows.py``; the
scipy.signal.windows set).

Windows are host float64 numpy plan constants: the spectral layer builds
its matrices from them on the host and uploads the result once. This is
the port's own copy of tpufft's module, kept so the port never imports
tpufft: construction matches scipy.signal.windows bit for bit (cosine-sum
windows evaluate sum_k a_k cos(k * linspace(-pi, pi, M)); periodic
windows compute the M+1-point symmetric window and drop the last sample),
and dpss uses scipy's tridiagonal eigensolver where scipy is installed,
as tpufft does. Names outside the native set fall back to scipy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_window", "boxcar", "triang", "bartlett", "hann",
           "hamming", "blackman", "blackmanharris", "nuttall", "flattop",
           "barthann", "cosine", "bohman", "parzen", "lanczos", "kaiser",
           "gaussian", "general_gaussian", "general_hamming",
           "general_cosine", "tukey", "exponential", "chebwin", "taylor",
           "kaiser_bessel_derived", "dpss"]


def _len_guard(M: int) -> bool:
    """True when the trivial small-M result should be returned."""
    if int(M) != M or M < 0:
        raise ValueError("Window length M must be a non-negative integer")
    return M <= 1


def _extend(M: int, sym: bool) -> tuple:
    """(window size to compute, needs_trunc): periodic = sym of M+1."""
    return (M, False) if sym else (M + 1, True)


def _trunc(w: np.ndarray, needed: bool) -> np.ndarray:
    return w[:-1] if needed else w


def general_cosine(M: int, a, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    fac = np.linspace(-np.pi, np.pi, M)
    w = np.zeros(M)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * fac)
    return _trunc(w, trunc)


def boxcar(M: int, sym: bool = True) -> np.ndarray:
    if int(M) != M or M < 0:
        raise ValueError("Window length M must be a non-negative integer")
    return np.ones(M, float)


def hann(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.5, 0.5], sym)


def hamming(M: int, sym: bool = True) -> np.ndarray:
    return general_hamming(M, 0.54, sym)


def general_hamming(M: int, alpha: float, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [alpha, 1.0 - alpha], sym)


def blackman(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.42, 0.50, 0.08], sym)


def blackmanharris(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def nuttall(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.3635819, 0.4891775, 0.1365995, 0.0106411],
                          sym)


def flattop(M: int, sym: bool = True) -> np.ndarray:
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(M, a, sym)


def bartlett(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M)
    w = np.where(np.less_equal(n, (M - 1) / 2.0),
                 2.0 * n / (M - 1), 2.0 - 2.0 * n / (M - 1))
    return _trunc(w, trunc)


def triang(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(1, (M + 1) // 2 + 1)
    if M % 2 == 0:
        w = (2 * n - 1.0) / M
        w = np.r_[w, w[::-1]]
    else:
        w = 2 * n / (M + 1.0)
        w = np.r_[w, w[-2::-1]]
    return _trunc(w, trunc)


def barthann(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M)
    fac = np.abs(n / (M - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _trunc(w, trunc)


def cosine(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    w = np.sin(np.pi / M * (np.arange(0, M) + 0.5))
    return _trunc(w, trunc)


def bohman(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    fac = np.abs(np.linspace(-1, 1, M)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    w = np.r_[0, w, 0]
    return _trunc(w, trunc)


def parzen(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(-(M - 1) / 2.0, (M - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(n < -(M - 1) / 4.0, n)
    nb = np.extract(abs(n) <= (M - 1) / 4.0, n)
    wa = 2 * (1 - np.abs(na) / (M / 2.0)) ** 3.0
    wb = (1 - 6 * (np.abs(nb) / (M / 2.0)) ** 2.0
          + 6 * (np.abs(nb) / (M / 2.0)) ** 3.0)
    w = np.r_[wa, wb, wa[::-1]]
    return _trunc(w, trunc)


def lanczos(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    w = np.sinc(2 * np.arange(M) / (M - 1) - 1.0)
    return _trunc(w, trunc)


def kaiser(M: int, beta: float, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M)
    alpha = (M - 1) / 2.0
    w = (np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2.0))
         / np.i0(beta))
    return _trunc(w, trunc)


def gaussian(M: int, std: float, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M) - (M - 1.0) / 2.0
    sig2 = 2 * std * std
    w = np.exp(-n ** 2 / sig2)
    return _trunc(w, trunc)


def general_gaussian(M: int, p: float, sig: float,
                     sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M) - (M - 1.0) / 2.0
    w = np.exp(-0.5 * np.abs(n / sig) ** (2 * p))
    return _trunc(w, trunc)


def tukey(M: int, alpha: float = 0.5, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    if alpha <= 0:
        return np.ones(M, "d")
    if alpha >= 1.0:
        return hann(M, sym=sym)
    M, trunc = _extend(M, sym)
    n = np.arange(0, M)
    width = int(np.floor(alpha * (M - 1) / 2.0))
    n1 = n[0:width + 1]
    n2 = n[width + 1:M - width - 1]
    n3 = n[M - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (M - 1))))
    w2 = np.ones(n2.shape[0])
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1
                                    + 2.0 * n3 / alpha / (M - 1))))
    return _trunc(np.concatenate((w1, w2, w3)), trunc)


def exponential(M: int, center=None, tau: float = 1.0,
                sym: bool = True) -> np.ndarray:
    if sym and center is not None:
        raise ValueError("If sym==True, center must be None.")
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    if center is None:
        center = (M - 1) / 2
    n = np.arange(0, M)
    w = np.exp(-np.abs(n - center) / tau)
    return _trunc(w, trunc)


def chebwin(M: int, at: float, sym: bool = True) -> np.ndarray:
    """Dolph-Chebyshev window: minimum main-lobe width for a given
    sidelobe attenuation ``at`` (dB). Classical construction: the
    frequency response is the order-(M-1) Chebyshev polynomial evaluated
    on a cosine grid; the window is its inverse DFT."""
    import warnings as _warnings
    if abs(at) < 45:
        _warnings.warn("This window is not suitable for spectral analysis "
                       "for attenuation levels below about 45dB because "
                       "the equivalent noise bandwidth of a Chebyshev "
                       "window does not grow monotonically.")
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    order = M - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (abs(at) / 20.0)))
    k = np.arange(M, dtype=np.float64)
    x = beta * np.cos(np.pi * k / M)
    # T_order(x), evaluated stably on all three branches
    p = np.zeros(M)
    inside = np.abs(x) <= 1
    p[inside] = np.cos(order * np.arccos(x[inside]))
    above = x > 1
    p[above] = np.cosh(order * np.arccosh(x[above]))
    below = x < -1
    p[below] = (2 * (M % 2) - 1) * np.cosh(order * np.arccosh(-x[below]))
    if M % 2:
        w = np.real(np.fft.fft(p))
        n = (M + 1) // 2
        w = w[:n]
        w = np.concatenate((w[n - 1:0:-1], w))
    else:
        # even length: half-sample phase shift before the DFT
        p = p * np.exp(1j * np.pi / M * np.arange(M))
        w = np.real(np.fft.fft(p))
        n = M // 2 + 1
        w = np.concatenate((w[n - 1:0:-1], w[1:n]))
    w = w / np.max(w)
    return _trunc(w, trunc)


def taylor(M: int, nbar: int = 4, sll: float = 30, norm: bool = True,
           sym: bool = True) -> np.ndarray:
    """Taylor window (SAR standard): near-Chebyshev sidelobe level
    ``sll`` dB with the ``nbar`` nearest sidelobes constrained; the
    classical F_m cosine-series coefficients."""
    if _len_guard(M):
        return np.ones(M)
    M, trunc = _extend(M, sym)
    B = 10.0 ** (float(sll) / 20.0)
    A = np.arccosh(B) / np.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)
    Fm = np.empty(nbar - 1)
    signs = np.empty_like(Fm)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma * ma
    for mi, m in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / (s2 * (A ** 2 + (ma - 0.5) ** 2)))
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1:])
        Fm[mi] = numer / denom
    n = np.arange(M, dtype=np.float64)
    w = np.ones(M)
    for mi, m in enumerate(ma):
        w += 2 * Fm[mi] * np.cos(2 * np.pi * m * (n - M / 2.0 + 0.5) / M)
    if norm:
        # unit gain at the window center (continuous-index midpoint)
        scale = 1.0 / (1.0 + 2 * np.sum(
            Fm * np.cos(2 * np.pi * ma * ((M - 1) / 2.0 - M / 2.0 + 0.5)
                        / M)))
        w = w * scale
    return _trunc(w, trunc)


def kaiser_bessel_derived(M: int, beta: float,
                          sym: bool = True) -> np.ndarray:
    """Kaiser-Bessel derived (KBD) window: square-root of the normalized
    Kaiser cumulative sum, mirrored — satisfies the Princen-Bradley
    condition for MDCT filterbanks."""
    if not sym:
        raise ValueError("Kaiser-Bessel Derived windows are only defined "
                         "for symmetric shapes")
    if M < 1:
        return np.array([])
    if M % 2:
        raise ValueError("Kaiser-Bessel Derived windows are only defined "
                         "for even number of points")
    kw = kaiser(M // 2 + 1, beta, sym=True)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate((half, half[::-1]))


def dpss(M: int, NW: float, Kmax=None, sym: bool = True, norm=None,
         return_ratios: bool = False):
    """Discrete prolate spheroidal (Slepian) sequences.

    The k-th DPSS is the k-th eigenvector of the tridiagonal
    spectral-concentration operator (Slepian 1978, eq. 14 — diagonal
    ((M-1-2t)/2)^2 cos(2 pi W), off-diagonal t(M-t)/2); concentration
    ratios come from the Toeplitz sinc quadratic form. Uses
    scipy.linalg.eigh_tridiagonal when available, dense eigh otherwise
    (host f64 plan-time math either way)."""
    if _len_guard(M):
        out = np.ones((1, M)) if Kmax is not None else np.ones(M)
        return (out, np.ones(1)) if return_ratios else out
    singleton = Kmax is None
    Kmax = 1 if singleton else int(Kmax)
    if not 0 < Kmax <= M:
        raise ValueError("Kmax must be in [1, M]")
    if not 0 < NW < M / 2.0:
        raise ValueError("NW must be in (0, M/2)")
    if norm is None:
        norm = "approximate" if singleton else 2
    if norm not in (2, "approximate", "subsample"):
        raise ValueError(f"invalid norm {norm!r}")
    M, trunc = _extend(M, sym)
    W = float(NW) / M
    t = np.arange(M, dtype=np.float64)
    diag = ((M - 1 - 2 * t) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    off = t[1:] * (M - t[1:]) / 2.0
    try:
        from scipy.linalg import eigh_tridiagonal
        _, wins = eigh_tridiagonal(diag, off,
                                   select="i",
                                   select_range=(M - Kmax, M - 1))
        wins = wins[:, ::-1].T
    except ImportError:
        A = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
        _, vec = np.linalg.eigh(A)
        wins = vec[:, -Kmax:][:, ::-1].T
    # sign conventions (scipy's): symmetric sequences have positive
    # mean; antisymmetric ones start with a positive slope
    fix = wins[::2].sum(axis=1) < 0
    wins[::2][fix] *= -1
    thresh = max(1e-7, 1.0 / M)
    for i in range(1, Kmax, 2):
        first = wins[i][np.abs(wins[i]) > thresh][0]
        if first < 0:
            wins[i] *= -1
    ratios = None
    if return_ratios:
        # concentration ratios: quadratic form of the symmetric
        # Toeplitz sinc (ideal-lowpass) matrix T[j,k] = r[|j-k|]. The
        # matvec is one convolution with the two-sided kernel r[|i|] —
        # O(M) memory, no dense matrix
        n = np.arange(1, M, dtype=np.float64)
        r = np.empty(M)
        r[0] = 2 * W
        r[1:] = np.sin(2 * np.pi * W * n) / (np.pi * n)
        r_sym = np.concatenate((r[:0:-1], r))
        ratios = np.empty(Kmax)
        for i in range(Kmax):
            v = wins[i]
            Tv = np.convolve(v, r_sym)[M - 1:2 * M - 1]
            ratios[i] = (v @ Tv) / (v @ v)
    if norm == 2:
        wins /= np.sqrt(np.sum(wins ** 2, axis=1, keepdims=True))
    else:
        # one GLOBAL scale: the k=0 window's peak (so higher orders keep
        # their relative amplitude), then an even-length correction for
        # the peak falling between samples — both from window 0
        wins /= wins.max()
        if M % 2 == 0:
            if norm == "approximate":
                correction = M * M / float(M * M + NW)
            else:
                # evaluate window 0 at the inter-sample midpoint
                # t = (M-1)/2 through its rfft (trigonometric
                # interpolation; every m >= 1 bin doubled)
                s = np.fft.rfft(wins[0])
                shift = -(1 - 1.0 / M) * np.arange(1, M // 2 + 1)
                s[1:] *= 2 * np.exp(-1j * np.pi * shift)
                correction = M / s.real.sum()
            wins *= correction
    if trunc:
        wins = wins[:, :-1]
    if singleton:
        wins = wins[0]
        return (wins, ratios[0]) if return_ratios else wins
    return (wins, ratios) if return_ratios else wins


# name -> (function, n_params) with scipy's aliases
_WINDOWS = {}
for _names, _fn, _np_ in [
    (("boxcar", "box", "ones", "rect", "rectangular"), boxcar, 0),
    (("triang", "triangle", "tri"), triang, 0),
    (("bartlett", "bart", "brt"), bartlett, 0),
    (("hann", "han"), hann, 0),
    (("hamming", "hamm", "ham"), hamming, 0),
    (("blackman", "black", "blk"), blackman, 0),
    (("blackmanharris", "blackharr", "bkh"), blackmanharris, 0),
    (("nuttall", "nutl", "nut"), nuttall, 0),
    (("flattop", "flat", "flt"), flattop, 0),
    (("barthann", "brthan", "bth"), barthann, 0),
    (("cosine", "halfcosine"), cosine, 0),
    (("bohman", "bman", "bmn"), bohman, 0),
    (("parzen", "parz", "par"), parzen, 0),
    (("lanczos", "sinc"), lanczos, 0),
    (("kaiser", "ksr"), kaiser, 1),
    (("gaussian", "gauss", "gss"), gaussian, 1),
    (("general gaussian", "general_gaussian", "general gauss",
      "general_gauss", "ggs"), general_gaussian, 2),
    (("general hamming", "general_hamming"), general_hamming, 1),
    (("general cosine", "general_cosine"), general_cosine, 1),
    (("tukey", "tuk"), tukey, -1),          # optional parameter
    (("exponential", "poisson"), exponential, -2),
    (("chebwin", "cheb"), chebwin, 1),
    (("taylor", "taylr", "taylor_win"), taylor, -1),
    (("dpss",), dpss, 1),
    (("kaiser bessel derived", "kaiser_bessel_derived", "kbd"),
     kaiser_bessel_derived, 1),
]:
    for _n in _names:
        _WINDOWS[_n] = (_fn, _np_)


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """scipy.signal.get_window-compatible dispatch, natively implemented
    for the full scipy window set (f64 host plan constants), including
    chebwin, taylor, dpss and kaiser_bessel_derived; truly unknown
    names fall back to scipy when available."""
    sym = not fftbins
    if isinstance(window, str):
        args = ()
    elif isinstance(window, tuple):
        if len(window) == 0:
            raise ValueError("window tuple must have at least one entry")
        if not isinstance(window[0], str):
            raise ValueError(f"first entry of window tuple {window!r} "
                             "must be a window-name string")
        window, args = window[0], tuple(window[1:])
    else:
        # bare number (incl. numpy scalars) = kaiser beta, like scipy
        try:
            beta = float(window)
        except (TypeError, ValueError) as e:
            # e.g. a pre-built vector (scipy raises here too; the
            # spectral layer's _triage_segments handles arrays before
            # reaching us)
            raise ValueError(
                f"unknown window specification {window!r}") from e
        window, args = "kaiser", (beta,)

    try:
        fn, npar = _WINDOWS[window.lower()]
    except KeyError:
        # unknown name: scipy fallback (covers the _SCIPY_ONLY set and
        # lets scipy raise its own error for true typos)
        try:
            from scipy.signal import get_window as _gw
        except ImportError as e:
            raise ValueError(
                f"window {window!r} is not in the native window set "
                f"({sorted(set(_WINDOWS))}) and scipy is not "
                "installed for the fallback") from e
        spec = (window, *args) if args else window
        return np.asarray(_gw(spec, Nx, fftbins=fftbins), np.float64)
    if npar == 0:
        if args:
            raise ValueError(f"window {window!r} takes no parameters")
        w = fn(Nx, sym=sym)
    elif npar == -1:            # tukey: one optional parameter
        w = fn(Nx, *args, sym=sym)
    elif npar == -2:            # exponential: center/tau optional
        w = fn(Nx, *args, sym=sym)
    else:
        if len(args) != npar:
            raise ValueError(f"window {window!r} requires {npar} "
                             f"parameter(s), got {len(args)}")
        w = fn(Nx, *args, sym=sym)
    return np.asarray(w, np.float64)
