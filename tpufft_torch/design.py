"""Filter design (counterpart of ``tpufft/design.py``; scipy.signal
semantics): FIR and IIR design, order selection, the representation
converters, residues and frequency-response evaluation.

All coefficient math is float64 host numpy: O(N) scalar work on tiny
arrays that must be exact, so it never runs on the device. The layers that
run the designed filters (``iir``, ``multirate``, ``sigtools``) upload the
coefficients as constants.

Contents, in tpufft's order: the analog lowpass prototypes (``buttap``,
``cheb1ap``, ``cheb2ap``, ``ellipap`` on the Landen-transformation form of
the Jacobi elliptic functions, ``besselap``), the zpk and tf frequency
transforms and the bilinear transform, ``iirfilter`` and its wrappers,
the converters (``zpk2tf``, ``normalize``, ``tf2zpk``, ``zpk2sos``,
``tf2sos``, ``sos2tf``, ``sos2zpk``), order selection (``buttord``,
``cheb1ord``, ``cheb2ord``, ``ellipord``, ``iirdesign``), FIR design
(``firwin`` and ``firwin_2d`` on the port's ``windows.get_window``,
``firwin2`` through the port's own ``irfft`` on the CPU, ``kaiserord``,
``remez``, ``firls``, ``minimum_phase``, ``gammatone``), the notch, peak
and comb filters, residues (``residue``, ``residuez``, ``invres``,
``invresz``, ``unique_roots``, ``lfiltic``), the steady-state initial
conditions ``lfilter_zi``/``sosfilt_zi``, and the frequency responses
(``freqz``, ``freqz_zpk``, ``sosfreqz``/``freqz_sos``, ``group_delay``,
``freqs``, ``freqs_zpk``, ``findfreqs``).

``freqz`` is the one function here that runs on the device. Its input
contract is tpufft's: numpy coefficients give numpy, evaluated on the host
in float64 (by the port's FFT on a CPU complex128 tensor where the grid is
an FFT's, else by Horner's rule); a tensor numerator runs where it lies
and its response stays a tensor there. With a scalar denominator and an
integer ``worN`` the response of the zero-padded numerator IS its DFT, so
a tensor numerator goes through the port's ``fft`` along axis 0 (a 1-D
numerator is one zero-padded minor row; a ``(taps, filters)`` bank is a
strided axis); every other tensor case is Horner's rule in torch ops on
the tensor's device, never a host copy.

``zpk2sos`` pairs each pole unit with the nearest zero unit and emits the
sections farthest-from-the-unit-circle poles first; its sections are
response-equivalent to scipy's, not byte-equal (sos factorizations are
not unique). Bandstop order selection matches scipy: all four ord
functions minimize the continuous order over the movable passband edges
before ceiling to N.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .api import fft, irfft
from .windows import get_window

__all__ = [
    "firwin", "firwin2", "firwin_2d", "firls", "remez", "minimum_phase",
    "gammatone",
    "kaiser_beta", "kaiser_atten", "kaiserord",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "lp2lp", "lp2hp", "lp2bp", "lp2bs",
    "bilinear", "bilinear_zpk",
    "iirfilter", "butter", "cheby1", "cheby2", "ellip", "bessel",
    "iirnotch", "iirpeak", "iircomb", "iirdesign",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "band_stop_obj",
    "zpk2tf", "tf2zpk", "zpk2sos", "tf2sos", "sos2tf", "sos2zpk",
    "normalize",
    "BadCoefficients",
    "freqz", "freqz_zpk", "sosfreqz", "freqz_sos", "group_delay",
    "freqs", "freqs_zpk", "findfreqs",
    "residue", "residuez", "invres", "invresz", "unique_roots",
    "lfilter_zi", "sosfilt_zi", "lfiltic",
]

_EPS = np.finfo(np.float64).eps


class BadCoefficients(UserWarning):
    """Warning about badly conditioned filter coefficients
    (scipy.signal.BadCoefficients-compatible)."""


# ---------------------------------------------------------------------------
# Jacobi elliptic machinery (Landen transformations; Orfanidis formulation)
# ---------------------------------------------------------------------------

def _landen(k: float, kp0=None) -> list:
    """Descending Landen sequence k -> 0 (quadratic convergence).

    kp0, when given, is the exact complementary modulus sqrt(1-k^2) of the
    FIRST step — for k extremely close to 1 the subtraction 1-k*k loses
    half the complement's digits, and the caller often knows it exactly
    (the degree equation seeds kc's sequence with k1 itself).
    """
    v = []
    k = float(k)
    first = kp0
    while k > _EPS:
        kp = first if first is not None else \
            math.sqrt(max(0.0, 1.0 - k * k))
        first = None
        k = (1.0 - kp) / (1.0 + kp)
        v.append(k)
        if len(v) > 64:  # paranoia: never observed past ~10
            break
    return v


def _ellipk(k: float) -> float:
    """Complete elliptic integral K(k) (modulus k, NOT parameter m=k^2)."""
    if k >= 1.0:
        return np.inf
    prod = 1.0
    for vn in _landen(k):
        prod *= 1.0 + vn
    return prod * math.pi / 2.0


def _cde(u, k: float):
    """Jacobi cd(u*K, k) for real or complex u (u in units of K)."""
    v = _landen(k)
    w = np.cos(np.asarray(u) * (math.pi / 2.0))
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _sne(u, k: float, kp0=None):
    """Jacobi sn(u*K, k) for real or complex u (u in units of K)."""
    v = _landen(k, kp0)
    w = np.sin(np.asarray(u) * (math.pi / 2.0))
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _acde(w, k: float):
    """Inverse cd: u with cd(u*K, k) = w (complex capable)."""
    v = _landen(k)
    w = np.asarray(w, np.complex128)
    for n, vn in enumerate(v):
        v1 = k if n == 0 else v[n - 1]
        w = 2.0 * w / ((1.0 + vn) * (1.0 + np.sqrt(1.0 - (w * v1) ** 2)))
    return 2.0 / math.pi * np.arccos(w)


def _asne(w, k: float):
    """Inverse sn: u with sn(u*K, k) = w (complex capable)."""
    return 1.0 - _acde(w, k)


def _ellipdeg(N: int, k1: float) -> float:
    """Solve the elliptic degree equation for the module k given N, k1."""
    kc = math.sqrt(max(0.0, 1.0 - k1 * k1))
    L = N // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / N
    kp = kc ** N * float(np.prod(_sne(ui, kc, kp0=k1))) ** 4
    return math.sqrt(max(0.0, 1.0 - kp * kp))


# ---------------------------------------------------------------------------
# Analog lowpass prototypes (cutoff 1 rad/s, zpk form)
# ---------------------------------------------------------------------------

def buttap(N: int):
    """Butterworth analog prototype: N poles on the unit circle, LHP."""
    N = _check_order(N)
    k = np.arange(1, N + 1)
    p = np.exp(1j * math.pi * (2 * k + N - 1) / (2 * N))
    return np.array([], np.complex128), p.astype(np.complex128), 1.0


def cheb1ap(N: int, rp: float):
    """Chebyshev-I analog prototype (rp dB passband ripple)."""
    N = _check_order(N)
    eps = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = math.asinh(1.0 / eps) / N
    theta = math.pi * (2 * np.arange(1, N + 1) - 1) / (2 * N)
    p = -math.sinh(mu) * np.sin(theta) + 1j * math.cosh(mu) * np.cos(theta)
    k = float(np.real(np.prod(-p)))
    if N % 2 == 0:
        k /= math.sqrt(1.0 + eps * eps)
    return np.array([], np.complex128), p.astype(np.complex128), k


def cheb2ap(N: int, rs: float):
    """Chebyshev-II (inverse) analog prototype (rs dB stopband atten)."""
    N = _check_order(N)
    de = 1.0 / math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = math.asinh(1.0 / de) / N
    theta = math.pi * (2 * np.arange(1, N + 1) - 1) / (2 * N)
    # Chebyshev-I poles, inverted; zeros on the jw axis at sec(theta)
    p = -(math.sinh(mu) * np.sin(theta) + 1j * math.cosh(mu) * np.cos(theta))
    p = 1.0 / p
    c = np.cos(theta)
    z = 1j / c[np.abs(c) > 1e-12]  # drop the middle zero (odd N)
    z = np.conj(z)
    k = float(np.real(np.prod(-p) / np.prod(-z)))
    return z.astype(np.complex128), p.astype(np.complex128), k


def ellipap(N: int, rp: float, rs: float):
    """Elliptic (Cauer) analog prototype — Landen-recursion design."""
    N = _check_order(N)
    ep = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    es = math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k1 = ep / es
    if N == 1:
        p = np.array([-1.0 / ep], np.complex128)
        return np.array([], np.complex128), p, float(np.real(np.prod(-p)))
    k = _ellipdeg(N, k1)
    L = N // 2
    r = N % 2
    ui = (2 * np.arange(1, L + 1) - 1.0) / N
    zeta = _cde(ui, k).real
    za = 1j / (k * zeta)
    z = np.concatenate([za, np.conj(za)])
    v0 = float(np.real(-1j * _asne(1j / ep, k1))) / N
    pa = 1j * _cde(ui - 1j * v0, k)
    p = np.concatenate([pa, np.conj(pa)])
    if r:
        p0 = 1j * _sne(1j * v0, k)
        p = np.concatenate([p, [complex(p0)]])
    h0 = 1.0 if r else 10.0 ** (-rp / 20.0)
    k_gain = h0 * float(np.real(np.prod(-p) / np.prod(-z)))
    return z.astype(np.complex128), p.astype(np.complex128), k_gain


def _reverse_bessel_poly(N: int) -> np.ndarray:
    """theta_N(s) coefficients, highest power first (exact integers)."""
    c = [math.factorial(2 * N - j)
         // (2 ** (N - j) * math.factorial(j) * math.factorial(N - j))
         for j in range(N, -1, -1)]
    return np.array(c, np.float64)


def besselap(N: int, norm: str = "phase"):
    """Bessel/Thomson analog prototype.

    norm='delay': unit group delay at DC. norm='phase': asymptote-matched
    to Butterworth — poles scaled by theta_N(0)^(-1/N), which puts the
    phase midpoint at w=1 (scipy default; closed form). norm='mag':
    -3 dB at w=1, solved by bisection on the delay-normalized poles.
    """
    N = _check_order(N)
    if norm not in ("phase", "delay", "mag"):
        raise ValueError("norm must be 'phase', 'delay' or 'mag'")
    if N == 0:
        return np.array([], np.complex128), np.array([], np.complex128), 1.0
    a = _reverse_bessel_poly(N)
    p = np.roots(a)  # theta_N is monic; prod(-p) = a[-1]
    da = a[:-1] * np.arange(N, 0, -1)
    for _ in range(2):  # Newton polish (np.roots drifts by ~1e-7 at N~9)
        p -= np.polyval(a, p) / np.polyval(da, p)
    a0 = a[-1]

    if norm == "delay":
        w0 = 1.0
    elif norm == "phase":
        w0 = a0 ** (1.0 / N)
    else:
        def f(w):
            return (abs(a0 / np.prod(1j * w - p)) ** 2) - 0.5
        lo, hi = 1e-6, 1e6
        flo = f(lo)
        for _ in range(200):
            mid = math.sqrt(lo * hi)  # geometric bisection (decades apart)
            if (f(mid) > 0) == (flo > 0):
                lo = mid
            else:
                hi = mid
            if hi / lo < 1 + 1e-15:
                break
        w0 = math.sqrt(lo * hi)
    p = p / w0
    k = float(np.real(np.prod(-p)))
    return np.array([], np.complex128), p.astype(np.complex128), k


def _check_order(N) -> int:
    import operator
    N = operator.index(N)
    if N < 0:
        raise ValueError("filter order must be non-negative")
    return N


# ---------------------------------------------------------------------------
# Frequency transformations (zpk form) and the bilinear transform
# ---------------------------------------------------------------------------

def _zpk_arrays(z, p):
    z = np.atleast_1d(np.asarray(z, np.complex128))
    p = np.atleast_1d(np.asarray(p, np.complex128))
    return z, p


def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> lowpass at cutoff wo (rad/s)."""
    z, p = _zpk_arrays(z, p)
    degree = _relative_degree(z, p)
    return z * wo, p * wo, k * wo ** degree


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> highpass at cutoff wo (rad/s)."""
    z, p = _zpk_arrays(z, p)
    degree = _relative_degree(z, p)
    z_hp = wo / z if z.size else z
    p_hp = wo / p
    z_hp = np.append(z_hp, np.zeros(degree))
    k_hp = k * float(np.real(np.prod(-z) / np.prod(-p)))
    return z_hp, p_hp, k_hp


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass (center wo, bandwidth bw, rad/s)."""
    z, p = _zpk_arrays(z, p)
    degree = _relative_degree(z, p)
    z_lp = z * bw / 2.0
    p_lp = p * bw / 2.0
    z_bp = np.concatenate([z_lp + np.sqrt(z_lp ** 2 - wo ** 2),
                           z_lp - np.sqrt(z_lp ** 2 - wo ** 2)])
    p_bp = np.concatenate([p_lp + np.sqrt(p_lp ** 2 - wo ** 2),
                           p_lp - np.sqrt(p_lp ** 2 - wo ** 2)])
    z_bp = np.append(z_bp, np.zeros(degree))
    return z_bp, p_bp, k * bw ** degree


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop (center wo, bandwidth bw, rad/s)."""
    z, p = _zpk_arrays(z, p)
    degree = _relative_degree(z, p)
    z_hp = (bw / 2.0) / z if z.size else z
    p_hp = (bw / 2.0) / p
    z_bs = np.concatenate([z_hp + np.sqrt(z_hp ** 2 - wo ** 2),
                           z_hp - np.sqrt(z_hp ** 2 - wo ** 2)])
    p_bs = np.concatenate([p_hp + np.sqrt(p_hp ** 2 - wo ** 2),
                           p_hp - np.sqrt(p_hp ** 2 - wo ** 2)])
    z_bs = np.append(z_bs, np.concatenate([1j * wo * np.ones(degree),
                                           -1j * wo * np.ones(degree)]))
    k_bs = k * float(np.real(np.prod(-z) / np.prod(-p)))
    return z_bs, p_bs, k_bs


def _relative_degree(z, p) -> int:
    degree = len(p) - len(z)
    if degree < 0:
        raise ValueError("improper transfer function: more zeros than poles")
    return degree


def bilinear_zpk(z, p, k, fs: float):
    """Analog zpk -> digital zpk via the bilinear (Tustin) transform."""
    z, p = _zpk_arrays(z, p)
    degree = _relative_degree(z, p)
    fs2 = 2.0 * float(fs)
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * float(np.real(np.prod(fs2 - z) / np.prod(fs2 - p)))
    return z_d, p_d, k_d


def bilinear(b, a, fs: float = 1.0):
    """Analog (b, a) -> digital (b, a) via the bilinear transform."""
    z, p, k = tf2zpk(b, a)
    z_d, p_d, k_d = bilinear_zpk(z, p, k, fs)
    return zpk2tf(z_d, p_d, k_d)


# ---------------------------------------------------------------------------
# IIR design orchestrator and the classic entry points
# ---------------------------------------------------------------------------

_BTYPES = {"lowpass": "lowpass", "low": "lowpass", "lp": "lowpass",
           "highpass": "highpass", "high": "highpass", "hp": "highpass",
           "bandpass": "bandpass", "band": "bandpass", "bp": "bandpass",
           "pass": "bandpass",
           "bandstop": "bandstop", "stop": "bandstop", "bs": "bandstop",
           "bands": "bandstop"}

_FTYPES = {"butter": "butter", "butterworth": "butter",
           "cheby1": "cheby1", "chebyshev1": "cheby1", "cheby_1": "cheby1",
           "cheby2": "cheby2", "chebyshev2": "cheby2", "cheby_2": "cheby2",
           "ellip": "ellip", "elliptic": "ellip", "cauer": "ellip",
           "bessel": "bessel", "bessel_phase": "bessel_phase",
           "bessel_delay": "bessel_delay", "bessel_mag": "bessel_mag"}


def _validate_wn(Wn, btype: str, fs, analog: bool):
    Wn = np.atleast_1d(np.asarray(Wn, np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        Wn = 2.0 * Wn / float(fs)
    if btype in ("lowpass", "highpass"):
        if Wn.size != 1:
            raise ValueError(f"{btype} needs a scalar critical frequency")
    else:
        if Wn.size != 2:
            raise ValueError(f"{btype} needs [low, high] critical "
                             "frequencies")
        if Wn[0] >= Wn[1]:
            raise ValueError("Wn[0] must be less than Wn[1]")
    if not analog and (np.any(Wn <= 0) or np.any(Wn >= 1)):
        raise ValueError("digital critical frequencies must satisfy "
                         "0 < Wn < 1 (Wn = 1 is the Nyquist frequency)"
                         + ("" if fs is None else f" — got Wn*2/fs={Wn}"))
    if analog and np.any(Wn <= 0):
        raise ValueError("analog critical frequencies must be positive")
    return Wn


def iirfilter(N: int, Wn, rp=None, rs=None, btype: str = "band",
              analog: bool = False, ftype: str = "butter",
              output: str = "ba", fs=None):
    """Design an Nth-order IIR filter (scipy.signal.iirfilter-compatible).

    Prototype -> frequency transform -> (digital) bilinear, all in f64
    zpk form; conversion to 'ba'/'sos' happens last so coefficient
    round-off never compounds through the design.
    """
    try:
        btype = _BTYPES[btype.lower()]
    except KeyError:
        raise ValueError(f"invalid btype {btype!r}") from None
    try:
        ftype = _FTYPES[ftype.lower()]
    except KeyError:
        raise ValueError(f"invalid ftype {ftype!r}") from None
    if output not in ("ba", "zpk", "sos"):
        raise ValueError("output must be 'ba', 'zpk' or 'sos'")
    Wn = _validate_wn(Wn, btype, fs, analog)

    if ftype == "butter":
        z, p, k = buttap(N)
    elif ftype == "cheby1":
        if rp is None:
            raise ValueError("cheby1 needs passband ripple rp (dB)")
        z, p, k = cheb1ap(N, rp)
    elif ftype == "cheby2":
        if rs is None:
            raise ValueError("cheby2 needs stopband attenuation rs (dB)")
        z, p, k = cheb2ap(N, rs)
    elif ftype == "ellip":
        if rp is None or rs is None:
            raise ValueError("ellip needs both rp and rs (dB)")
        z, p, k = ellipap(N, rp, rs)
    else:  # bessel family
        norm = {"bessel": "phase", "bessel_phase": "phase",
                "bessel_delay": "delay", "bessel_mag": "mag"}[ftype]
        z, p, k = besselap(N, norm=norm)

    if analog:
        warped = Wn
    else:
        fs_internal = 2.0
        warped = 2.0 * fs_internal * np.tan(math.pi * Wn / fs_internal)

    if btype == "lowpass":
        z, p, k = lp2lp_zpk(z, p, k, wo=float(warped[0]))
    elif btype == "highpass":
        z, p, k = lp2hp_zpk(z, p, k, wo=float(warped[0]))
    elif btype == "bandpass":
        bw = float(warped[1] - warped[0])
        wo = float(np.sqrt(warped[0] * warped[1]))
        z, p, k = lp2bp_zpk(z, p, k, wo=wo, bw=bw)
    else:
        bw = float(warped[1] - warped[0])
        wo = float(np.sqrt(warped[0] * warped[1]))
        z, p, k = lp2bs_zpk(z, p, k, wo=wo, bw=bw)

    if not analog:
        z, p, k = bilinear_zpk(z, p, k, fs=fs_internal)

    if output == "zpk":
        return z, p, k
    if output == "ba":
        return zpk2tf(z, p, k)
    return zpk2sos(z, p, k)


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth filter design (scipy.signal.butter-compatible)."""
    return iirfilter(N, Wn, btype=btype, analog=analog, output=output,
                     ftype="butter", fs=fs)


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-I filter design (scipy.signal.cheby1-compatible)."""
    return iirfilter(N, Wn, rp=rp, btype=btype, analog=analog,
                     output=output, ftype="cheby1", fs=fs)


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-II filter design (scipy.signal.cheby2-compatible)."""
    return iirfilter(N, Wn, rs=rs, btype=btype, analog=analog,
                     output=output, ftype="cheby2", fs=fs)


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) filter design (scipy.signal.ellip-compatible)."""
    return iirfilter(N, Wn, rp=rp, rs=rs, btype=btype, analog=analog,
                     output=output, ftype="ellip", fs=fs)


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase",
           fs=None):
    """Bessel/Thomson filter design (scipy.signal.bessel-compatible)."""
    return iirfilter(N, Wn, btype=btype, analog=analog, output=output,
                     ftype={"phase": "bessel_phase", "delay": "bessel_delay",
                            "mag": "bessel_mag"}[norm], fs=fs)


# ---------------------------------------------------------------------------
# Representation converters
# ---------------------------------------------------------------------------

def _real_if_close(c: np.ndarray) -> np.ndarray:
    scale = max(1.0, float(np.abs(c).max(initial=0.0)))
    if np.iscomplexobj(c) and np.allclose(c.imag, 0.0,
                                          atol=1e4 * _EPS * scale):
        return c.real.copy()
    return c


def zpk2tf(z, p, k):
    """Zeros/poles/gain -> transfer-function (b, a) polynomials."""
    z, p = _zpk_arrays(z, p)
    b = _real_if_close(np.atleast_1d(k * np.poly(z)))
    a = _real_if_close(np.atleast_1d(np.poly(p)))
    return b, a


def normalize(b, a):
    """Normalize (b, a) so a[0] == 1; trims leading numerator zeros."""
    b = np.atleast_1d(np.asarray(b, np.float64 if not np.iscomplexobj(b)
                      else np.complex128))
    a = np.atleast_1d(np.asarray(a, np.float64 if not np.iscomplexobj(a)
                      else np.complex128))
    if a.ndim != 1 or b.ndim > 1:
        raise ValueError("b and a must be 1-D")
    if np.all(a == 0) or a[0] == 0:
        raise ValueError("denominator must have a nonzero leading "
                         "coefficient")
    b = b / a[0]
    a = a / a[0]
    # trim leading zeros of b (keep at least one coefficient)
    nz = np.nonzero(b)[0]
    if nz.size == 0:
        b = b[:1]
    elif nz[0] > 0:
        warnings.warn("badly conditioned transfer function: leading "
                      "numerator coefficients are zero",
                      BadCoefficients, stacklevel=2)
        b = b[nz[0]:]
    return b, a


def tf2zpk(b, a):
    """Transfer function (b, a) -> zeros/poles/gain."""
    b, a = normalize(b, a)
    k = float(np.real(b[0])) if not np.iscomplexobj(b) else complex(b[0])
    b = b / b[0] if b[0] != 0 else b
    z = np.roots(b) if len(b) > 1 else np.array([], np.complex128)
    p = np.roots(a) if len(a) > 1 else np.array([], np.complex128)
    return z, p, k


def _cplxreal(v, tol=None):
    """Split a root list into (upper-half conjugate-pair members, reals).

    Every strictly-complex root must have a conjugate partner within
    tolerance (pairs are averaged), mirroring scipy's contract.
    """
    v = np.atleast_1d(np.asarray(v, np.complex128))
    if v.size == 0:
        return v, v.real
    if tol is None:
        tol = 100.0 * _EPS
    scale = np.maximum(np.abs(v), 1.0)
    real_mask = np.abs(v.imag) <= tol * scale
    zr = np.sort(v[real_mask].real)
    vc = v[~real_mask]
    pos = vc[vc.imag > 0]
    neg = vc[vc.imag < 0]
    if pos.size != neg.size:
        raise ValueError("array has complex roots with no conjugate pair")
    order_p = np.lexsort((pos.imag, pos.real))
    order_n = np.lexsort((-neg.imag, neg.real))
    pos, neg = pos[order_p], neg[order_n]
    if not np.allclose(pos, np.conj(neg),
                       atol=tol * float(np.abs(vc).max(initial=1.0)),
                       rtol=tol):
        raise ValueError("array has complex roots with no conjugate pair")
    zc = (pos + np.conj(neg)) / 2.0
    return zc, zr


def _root_units(roots):
    """Group roots into degree-2/degree-1 units: conjugate pairs first,
    then reals paired by closeness to the unit circle (leftover real
    becomes a degree-1 unit)."""
    zc, zr = _cplxreal(roots)
    units = [[c, np.conj(c)] for c in zc]
    zr = sorted(zr, key=lambda r: abs(1.0 - abs(r)))
    while len(zr) >= 2:
        units.append([zr.pop(0), zr.pop(0)])
    if zr:
        units.append([zr.pop()])
    return units


def zpk2sos(z, p, k, *, pairing: str = "nearest"):
    """Zeros/poles/gain -> second-order sections.

    Pairing: conjugate pole pairs (and paired reals) are each matched with
    the remaining zero unit nearest in the z-plane; sections are emitted
    farthest-from-unit-circle poles first, so the highest-Q section runs
    last (scipy's peak-round-off ordering). The section set is
    response-equivalent to scipy's, not byte-identical — sos
    factorizations are not unique.
    """
    if pairing not in ("nearest",):
        raise ValueError("only pairing='nearest' is supported")
    z, p = _zpk_arrays(z, p)
    if len(z) == len(p) == 0:
        return np.array([[float(k), 0.0, 0.0, 1.0, 0.0, 0.0]])
    p_units = _root_units(p)
    z_units = _root_units(z)
    # poles farthest from the unit circle first (distance by max root
    # MODULUS, not np.mean — the mean of a conjugate pair is Re(p) and
    # misorders near-imaginary poles)
    p_units.sort(key=lambda u: -abs(1.0 - max(abs(r) for r in u)))
    while len(z_units) > len(p_units):
        p_units.append([])  # zero-excess sections get FIR-only slots
    sections = []
    for pu in p_units:
        if z_units:
            # nearest zero unit by true z-plane root distance
            def _dist(zu, pu=pu):
                if not pu:
                    return min(abs(r) for r in zu)
                return min(abs(zr - pr) for zr in zu for pr in pu)
            j = min(range(len(z_units)), key=lambda i: _dist(z_units[i]))
            zu = z_units.pop(j)
        else:
            zu = []
        b = np.real(np.poly(zu)) if zu else np.array([1.0])
        a = np.real(np.poly(pu)) if pu else np.array([1.0])
        b = np.concatenate([b, np.zeros(3 - b.size)])
        a = np.concatenate([a, np.zeros(3 - a.size)])
        sections.append(np.concatenate([b, a]))
    sos = np.array(sections)
    sos[0, :3] *= float(k)
    return sos


def tf2sos(b, a, *, pairing: str = "nearest"):
    """Transfer function -> second-order sections."""
    return zpk2sos(*tf2zpk(b, a), pairing=pairing)


def sos2tf(sos):
    """Second-order sections -> transfer function (b, a)."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    b, a = np.array([1.0]), np.array([1.0])
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    # trim trailing zero coefficients shared by construction
    while b.size > 1 and b[-1] == 0 and a.size > 1 and a[-1] == 0:
        b, a = b[:-1], a[:-1]
    return b, a


def sos2zpk(sos):
    """Second-order sections -> zeros/poles/gain (2 roots per section,
    origin-padded, matching scipy's convention)."""
    sos = np.asarray(sos, np.float64)
    n = sos.shape[0]
    z = np.zeros(2 * n, np.complex128)
    p = np.zeros(2 * n, np.complex128)
    k = 1.0
    for i, row in enumerate(sos):
        zi, pi, ki = tf2zpk(row[:3], row[3:])
        z[2 * i:2 * i + len(zi)] = zi
        p[2 * i:2 * i + len(pi)] = pi
        k *= ki
    return z, p, k


# ---------------------------------------------------------------------------
# Order selection
# ---------------------------------------------------------------------------

def _band_stop_obj(wp_edge: float, ind: int, passb, stopb,
                   gpass: float, gstop: float, kind: str) -> float:
    """Continuous (un-ceiled) filter order for a bandstop spec with one
    passband edge moved to ``wp_edge`` — the objective scipy's *ord
    functions minimize over the movable edge (scipy.signal
    _filter_design.band_stop_obj parity)."""
    pb = np.array(passb, np.float64)
    pb[ind] = float(np.atleast_1d(wp_edge)[0])
    nat = float(np.min(np.abs((stopb * (pb[0] - pb[1]))
                              / (stopb ** 2 - pb[0] * pb[1]))))
    gs, gp = _gd(gstop), _gd(gpass)
    if kind == "butter":
        return math.log10(gs / gp) / (2.0 * math.log10(nat))
    if kind == "cheby":
        return math.acosh(math.sqrt(gs / gp)) / math.acosh(nat)
    # elliptic: complete-elliptic-integral degree equation
    k = 1.0 / nat
    k1 = math.sqrt(gp / gs)
    kc = math.sqrt(max(0.0, 1.0 - k * k))
    k1c = math.sqrt(max(0.0, 1.0 - k1 * k1))
    return (_ellipk(k) * _ellipk(k1c)) / (_ellipk(kc) * _ellipk(k1))


def _fminbound(fun, a: float, b: float, args) -> float:
    """Bounded 1-D minimizer: scipy.optimize.fminbound when available
    (bit-parity with scipy's ord functions, which use it), else a
    golden-section fallback over the same bracket."""
    try:
        from scipy.optimize import fminbound
        return float(fminbound(fun, a, b, args=args, disp=0))
    except ImportError:
        pass
    inv = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - inv * (b - a), a + inv * (b - a)
    fc, fd = fun(c, *args), fun(d, *args)
    for _ in range(200):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv * (b - a)
            fc = fun(c, *args)
        else:
            a, c, fc = c, d, fd
            d = a + inv * (b - a)
            fd = fun(d, *args)
        if abs(b - a) <= 1e-12 * max(1.0, abs(b)):
            break
    return 0.5 * (a + b)


def _ord_prepare(wp, ws, analog: bool, fs, gpass=None, gstop=None,
                 kind=None):
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        wp, ws = 2.0 * wp / float(fs), 2.0 * ws / float(fs)
    if wp.shape != ws.shape or wp.size not in (1, 2):
        raise ValueError("wp and ws must both be scalars or both pairs")
    if wp.size == 1:
        btype = "lowpass" if wp[0] < ws[0] else "highpass"
    else:
        if not (wp[0] < wp[1] and ws[0] < ws[1]):
            raise ValueError("band edges must be increasing")
        if wp[0] > ws[0]:  # passband inside stopband edges
            btype = "bandpass"
        else:
            btype = "bandstop"
    if not analog:
        if np.any(wp <= 0) or np.any(wp >= 1) or np.any(ws <= 0) \
                or np.any(ws >= 1):
            raise ValueError("digital band edges must satisfy 0 < w < 1")
        warp = np.tan(math.pi * wp / 2.0)
        wars = np.tan(math.pi * ws / 2.0)
    else:
        warp, wars = wp, ws
    # selectivity: stop/pass edge ratio of the equivalent lowpass prototype
    if btype == "lowpass":
        nat = wars[0] / warp[0]
    elif btype == "highpass":
        nat = warp[0] / wars[0]
    elif btype == "bandpass":
        nat = min(abs((wars[i] ** 2 - warp[0] * warp[1])
                      / (wars[i] * (warp[0] - warp[1]))) for i in (0, 1))
    else:  # bandstop — scipy-parity numeric edge optimization
        if kind is not None:
            # minimize the continuous order over each movable passband
            # edge (scipy's buttord/cheb*ord/ellipord bandstop): bounded
            # search between the original passband edge and its stopband
            # edge, BOTH against the ORIGINAL passb (scipy _find_nat_freq)
            wp0 = _fminbound(_band_stop_obj, warp[0], wars[0] - 1e-12,
                             (0, warp, wars, gpass, gstop, kind))
            wp1 = _fminbound(_band_stop_obj, wars[1] + 1e-12, warp[1],
                             (1, warp, wars, gpass, gstop, kind))
            warp = np.array([wp0, wp1], np.float64)
        nat = min(abs((wars[i] * (warp[0] - warp[1]))
                      / (wars[i] ** 2 - warp[0] * warp[1])) for i in (0, 1))
    return wp, ws, warp, wars, float(nat), btype


def _gd(g: float) -> float:
    return 10.0 ** (0.1 * abs(g)) - 1.0


def buttord(wp, ws, gpass: float, gstop: float, analog: bool = False,
            fs=None):
    """Butterworth order selection (scipy.signal.buttord-compatible;
    returned Wn is the 3 dB corner meeting the passband spec exactly)."""
    wp, ws, warp, wars, nat, btype = _ord_prepare(
        wp, ws, analog, fs, gpass, gstop, "butter")
    N = int(math.ceil(math.log10(_gd(gstop) / _gd(gpass))
                      / (2.0 * math.log10(nat))))
    # prototype corner that meets gpass exactly, mapped back to this band
    W0 = _gd(gpass) ** (-1.0 / (2.0 * N))
    d = warp[-1] - warp[0]
    if btype == "lowpass":
        WN = np.array([W0 * warp[0]])
    elif btype == "highpass":
        WN = np.array([warp[0] / W0])
    elif btype == "bandpass":
        W0pm = np.array([-W0, W0])
        WN = (-W0pm * d / 2.0
              + np.sqrt(W0pm ** 2 / 4.0 * d ** 2 + warp[0] * warp[1]))
    else:  # bandstop
        disc = math.sqrt(d ** 2 + 4.0 * W0 ** 2 * warp[0] * warp[1])
        WN = np.array([(d + disc) / (2.0 * W0), (d - disc) / (2.0 * W0)])
    WN = np.sort(np.abs(np.atleast_1d(WN)))
    wn = WN if analog else (2.0 / math.pi) * np.arctan(WN)
    if fs is not None:
        wn = wn * float(fs) / 2.0
    wn = float(wn[0]) if wn.size == 1 else wn
    return N, wn


def cheb1ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs=None):
    """Chebyshev-I order selection; Wn is the passband edge (scipy) —
    for bandstop, the edge-OPTIMIZED passband edges, like scipy."""
    wp, ws, warp, _, nat, _ = _ord_prepare(
        wp, ws, analog, fs, gpass, gstop, "cheby")
    N = int(math.ceil(math.acosh(math.sqrt(_gd(gstop) / _gd(gpass)))
                      / math.acosh(nat)))
    wn = warp if analog else (2.0 / math.pi) * np.arctan(warp)
    if fs is not None:
        wn = wn * float(fs) / 2.0
    wn = float(wn[0]) if wn.size == 1 else wn
    return N, wn


def cheb2ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs=None):
    """Chebyshev-II order selection; Wn meets the passband spec exactly."""
    wp, ws, warp, wars, nat, btype = _ord_prepare(
        wp, ws, analog, fs, gpass, gstop, "cheby")
    N = int(math.ceil(math.acosh(math.sqrt(_gd(gstop) / _gd(gpass)))
                      / math.acosh(nat)))
    # corner that just meets gpass at the passband edge
    nf = 1.0 / math.cosh(math.acosh(math.sqrt(_gd(gstop) / _gd(gpass))) / N)
    if btype == "lowpass":
        WN = np.array([warp[0] / nf])
    elif btype == "highpass":
        WN = np.array([warp[0] * nf])
    elif btype == "bandpass":
        w0 = (warp[0] - warp[1]) / (2.0 * nf) \
            + math.sqrt((warp[1] - warp[0]) ** 2 / (4.0 * nf ** 2)
                        + warp[0] * warp[1])
        WN = np.array([w0, warp[0] * warp[1] / w0])
    else:  # bandstop
        w0 = nf / 2.0 * (warp[0] - warp[1]) \
            + math.sqrt(nf ** 2 * (warp[1] - warp[0]) ** 2 / 4.0
                        + warp[0] * warp[1])
        WN = np.array([w0, warp[0] * warp[1] / w0])
    WN = np.sort(np.abs(np.atleast_1d(WN)))
    wn = WN if analog else (2.0 / math.pi) * np.arctan(WN)
    if fs is not None:
        wn = wn * float(fs) / 2.0
    wn = float(wn[0]) if wn.size == 1 else wn
    return N, wn


def ellipord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs=None):
    """Elliptic order selection via the complete-elliptic-integral degree
    equation; Wn is the passband edge (scipy) — for bandstop, the
    edge-OPTIMIZED passband edges, like scipy."""
    wp, ws, warp, _, nat, _ = _ord_prepare(
        wp, ws, analog, fs, gpass, gstop, "ellip")
    k = 1.0 / nat
    k1 = math.sqrt(_gd(gpass) / _gd(gstop))
    kc = math.sqrt(max(0.0, 1.0 - k * k))
    k1c = math.sqrt(max(0.0, 1.0 - k1 * k1))
    N = int(math.ceil(_ellipk(k) * _ellipk(k1c)
                      / (_ellipk(kc) * _ellipk(k1))))
    wn = warp if analog else (2.0 / math.pi) * np.arctan(warp)
    if fs is not None:
        wn = wn * float(fs) / 2.0
    wn = float(wn[0]) if wn.size == 1 else wn
    return N, wn


# ---------------------------------------------------------------------------
# FIR design (windowed sinc)
# ---------------------------------------------------------------------------

def kaiser_beta(a: float) -> float:
    """Kaiser-window beta for a dB of sidelobe attenuation."""
    a = abs(a)
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser-window FIR of numtaps and transition
    width (fraction of Nyquist)."""
    return 2.285 * (numtaps - 1) * math.pi * width + 7.95


def kaiserord(ripple: float, width: float):
    """(numtaps, beta) meeting a ripple (dB) / transition-width spec."""
    A = abs(ripple)
    if A < 8:
        raise ValueError("ripple attenuation too small for the Kaiser "
                         "formula (need at least 8 dB)")
    beta = kaiser_beta(A)
    numtaps = (A - 7.95) / 2.285 / (math.pi * width) + 1
    return int(math.ceil(numtaps)), beta


_PASS_ZERO = {"bandpass": False, "lowpass": True, "highpass": False,
              "bandstop": True}


def firwin(numtaps: int, cutoff, width=None, window="hamming",
           pass_zero=True, scale: bool = True, fs=None):
    """Windowed-sinc FIR design (scipy.signal.firwin-compatible)."""
    import operator
    numtaps = operator.index(numtaps)
    if numtaps < 1:
        raise ValueError("numtaps must be at least 1")
    nyq = 1.0 if fs is None else float(fs) / 2.0
    cutoff = np.atleast_1d(np.asarray(cutoff, np.float64)) / nyq
    if cutoff.ndim > 1:
        raise ValueError("cutoff must be scalar or 1-D")
    if cutoff.size == 0:
        raise ValueError("at least one cutoff frequency required")
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoff must satisfy 0 < cutoff < fs/2")
    if np.any(np.diff(cutoff) <= 0):
        raise ValueError("cutoff frequencies must be strictly increasing")

    if isinstance(pass_zero, str):
        try:
            pz = _PASS_ZERO[pass_zero]
        except KeyError:
            raise ValueError(f"invalid pass_zero {pass_zero!r}") from None
        if pass_zero in ("lowpass", "highpass") and cutoff.size != 1:
            raise ValueError(f"{pass_zero} needs exactly one cutoff")
        if pass_zero in ("bandpass", "bandstop") and cutoff.size < 2:
            raise ValueError(f"{pass_zero} needs at least two cutoffs")
        pass_zero = pz
    pass_zero = bool(pass_zero)
    pass_nyquist = bool(cutoff.size & 1) ^ pass_zero
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError("an even-numtaps filter must have zero response "
                         "at the Nyquist frequency")

    if width is not None:
        atten = kaiser_atten(numtaps, width / nyq)
        window = ("kaiser", kaiser_beta(atten))

    cutoff = np.hstack([[0.0] * pass_zero, cutoff, [1.0] * pass_nyquist])
    bands = cutoff.reshape(-1, 2)
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps) - alpha
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)

    win = get_window(window, numtaps, fftbins=False)
    h *= win

    if scale:
        left, right = bands[0]
        if left == 0:
            f_scale = 0.0
        elif right == 1:
            f_scale = 1.0
        else:
            f_scale = 0.5 * (left + right)
        c = np.cos(math.pi * m * f_scale)
        h /= np.sum(h * c)
    return h


def firwin2(numtaps: int, freq, gain, nfreqs=None, window="hamming",
            antisymmetric: bool = False, fs=None):
    """FIR design by frequency sampling (scipy.signal.firwin2-compatible).

    The sampled response is inverted through the port's own irfft on the
    CPU in float64 — the design IS an inverse real FFT of the interpolated
    target response.
    """
    import operator
    numtaps = operator.index(numtaps)
    nyq = 1.0 if fs is None else float(fs) / 2.0
    freq = np.asarray(freq, np.float64)
    gain = np.asarray(gain, np.float64)
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise ValueError("freq and gain must be 1-D of the same length")
    if freq[0] != 0 or freq[-1] != nyq:
        raise ValueError(f"freq must start at 0 and end at fs/2 (= {nyq})")
    d = np.diff(freq)
    if np.any(d < 0):
        raise ValueError("freq must be nondecreasing")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(max(numtaps, 2))))
    if numtaps >= nfreqs:
        raise ValueError("nfreqs must exceed numtaps")

    # filter type: parity x (anti)symmetry, with the standard constraints
    if antisymmetric:
        ftype = 3 if numtaps % 2 else 4
    else:
        ftype = 1 if numtaps % 2 else 2
    if ftype == 2 and gain[-1] != 0.0:
        raise ValueError("type II filter (even numtaps, symmetric) must "
                         "have zero gain at Nyquist")
    if ftype == 3 and (gain[0] != 0.0 or gain[-1] != 0.0):
        raise ValueError("type III filter must have zero gain at 0 and "
                         "Nyquist")
    if ftype == 4 and gain[0] != 0.0:
        raise ValueError("type IV filter must have zero gain at 0")

    # nudge duplicated interior breakpoints apart so interp is one-sided
    freq = freq.copy()
    eps = np.finfo(np.float64).eps * nyq
    for i in range(1, freq.size - 1):
        if freq[i] == freq[i - 1]:
            freq[i - 1] -= eps
            freq[i] += eps
    if np.any(np.diff(freq) <= 0):
        raise ValueError("freq cannot contain more than two duplicates")

    x = np.linspace(0.0, nyq, nfreqs)
    fx = np.interp(x, freq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * math.pi * x / nyq)
    if ftype > 2:
        shift *= 1j
    fx2 = fx * shift

    out_full = irfft(fx2.astype(np.complex128), 2 * (nfreqs - 1),
                     device="cpu")
    win = get_window(window, numtaps, fftbins=False)
    out = out_full[:numtaps] * win
    if ftype == 3:
        out[numtaps // 2] = 0.0
    return out


# ---------------------------------------------------------------------------
# Frequency response evaluation
# ---------------------------------------------------------------------------

def _polyval_zinv(c: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Evaluate sum_k c[k] * exp(-1j*w*k) (Horner in z^-1, f64)."""
    zinv = np.exp(-1j * np.asarray(w, np.float64))
    h = np.zeros_like(zinv)
    for ck in c[::-1]:
        h = h * zinv + ck
    return h


def _polyval_zinv_tensor(c: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """``_polyval_zinv`` in torch ops on ``c``'s device: c (nb, ...) ->
    (len(w), ...), complex64 for a single-precision c, else complex128."""
    cdt = (torch.complex128 if c.dtype in (torch.float64, torch.complex128)
           else torch.complex64)
    c = c.to(cdt)
    zinv = torch.as_tensor(np.exp(-1j * np.asarray(w, np.float64)),
                           dtype=cdt, device=c.device)
    zinv = zinv.reshape((-1,) + (1,) * (c.ndim - 1))
    h = torch.zeros(zinv.shape[:1] + c.shape[1:], dtype=cdt, device=c.device)
    for k in range(c.shape[0] - 1, -1, -1):
        h = torch.addcmul(c[k], h, zinv)
    return h


def _uniform_grid(n: int, last: float, endpoint: bool) -> np.ndarray:
    """``np.linspace(0, last, n, endpoint=endpoint)`` in one allocation and
    one pass: at n = 2**20 the host's grid is most of a device ``freqz``'s
    time, and each fresh array of linspace's and of the fs scaling costs
    a pass and its page faults."""
    w = np.arange(n, dtype=np.float64)
    div = n - 1 if endpoint else n
    if div:
        w *= last / div
    return w


def freqz(b, a=1, worN=512, whole: bool = False, fs=2 * math.pi,
          include_nyquist: bool = False, *, config=None):
    """Digital filter frequency response (scipy.signal.freqz-compatible).

    Numpy coefficients evaluate on the host in float64: the port's FFT on a
    CPU complex128 tensor when the grid is an FFT's (scalar ``a``, integer
    ``worN``, n_fft >= max(32, len(b))), else Horner's rule. A tensor
    numerator with scalar ``a`` and integer ``worN`` (n_fft >= len(b)) goes
    through the port's ``fft`` along axis 0 on its device — the response
    at worN uniform points IS the DFT of the zero-padded coefficient
    vector; every other tensor case runs Horner's rule in torch ops on the
    tensor's device. Frequencies come back as numpy, the response in the
    numerator's form.
    """
    b_is_dev = isinstance(b, torch.Tensor)
    b_arr = np.atleast_1d(np.asarray(b)) if not b_is_dev else \
        torch.atleast_1d(b)
    a_arr = np.atleast_1d(np.asarray(a))
    a_scalar = a_arr.size == 1
    fs = float(fs)

    if isinstance(worN, (int, np.integer)):
        N = int(worN)
        if N < 1:
            raise ValueError("worN must be positive")
        lastpoint = 2 * math.pi if whole else math.pi
        endpoint = include_nyquist and not whole
        n_fft = N if whole else 2 * (N - (1 if include_nyquist else 0))
        nb = b_arr.shape[0]
        if a_scalar and n_fft >= nb and (b_is_dev or n_fft >= 32):
            if b_is_dev:
                h = fft(b_arr, n=n_fft, axis=0, config=config)
            else:
                h = fft(np.asarray(b_arr, np.complex128), n=n_fft, axis=0,
                        config=config, device="cpu")
            h = h[:N] / complex(a_arr[0])
            return _uniform_grid(N, lastpoint * fs / (2 * math.pi),
                                 endpoint), h
        w = np.linspace(0.0, lastpoint, N, endpoint=endpoint)
    else:
        w = np.asarray(worN, np.float64) * (2 * math.pi) / fs

    if b_is_dev:
        h = _polyval_zinv_tensor(b_arr, w)
        if not a_scalar:
            den = _polyval_zinv_tensor(
                torch.as_tensor(a_arr, device=b_arr.device).to(
                    torch.float64 if h.dtype == torch.complex128
                    else torch.float32), w)
            h = h / den.reshape(den.shape + (1,) * (h.ndim - 1))
        else:
            h = h / complex(a_arr[0])
        return w * fs / (2 * math.pi), h
    h = _polyval_zinv(np.asarray(b_arr, np.complex128), w)
    if not a_scalar:
        h = h / _polyval_zinv(np.asarray(a_arr, np.complex128), w)
    else:
        h = h / complex(a_arr[0])
    return w * fs / (2 * math.pi), h


def freqz_zpk(z, p, k, worN=512, whole: bool = False, fs=2 * math.pi):
    """Frequency response from zeros/poles/gain."""
    z, p = _zpk_arrays(z, p)
    fs = float(fs)
    if isinstance(worN, (int, np.integer)):
        lastpoint = 2 * math.pi if whole else math.pi
        w = np.linspace(0.0, lastpoint, int(worN), endpoint=False)
    else:
        w = np.asarray(worN, np.float64) * (2 * math.pi) / fs
    zm = np.exp(1j * w)
    h = np.full(w.shape, complex(k), np.complex128)
    for zi in z:
        h *= zm - zi
    for pi in p:
        h /= zm - pi
    return w * fs / (2 * math.pi), h


def sosfreqz(sos, worN=512, whole: bool = False, fs=2 * math.pi):
    """Frequency response of cascaded second-order sections."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    if sos.shape[0] == 0:
        raise ValueError("sos must have at least one section")
    h = None
    for row in sos:
        w, rowh = freqz(row[:3], row[3:], worN=worN, whole=whole, fs=fs)
        h = rowh if h is None else h * rowh
    return w, h


def group_delay(system, w=512, whole: bool = False, fs=2 * math.pi):
    """Group delay of a digital filter (b, a) in samples."""
    b, a = system
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    fs = float(fs)
    if isinstance(w, (int, np.integer)):
        lastpoint = 2 * math.pi if whole else math.pi
        wgrid = np.linspace(0.0, lastpoint, int(w), endpoint=False)
    else:
        wgrid = np.asarray(w, np.float64) * (2 * math.pi) / fs
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(c.size)
    z = np.exp(-1j * wgrid)
    num = np.polynomial.polynomial.polyval(z, cr.astype(np.complex128))
    den = np.polynomial.polynomial.polyval(z, c.astype(np.complex128))
    singular = np.abs(den) < 10.0 * _EPS * np.abs(cr).sum()
    if np.any(singular):
        warnings.warn("group_delay: frequency response is singular at "
                      "some evaluation points; setting group delay to 0 "
                      "there", stacklevel=2)
    gd = np.zeros_like(wgrid)
    ok = ~singular
    gd[ok] = np.real(num[ok] / den[ok]) - (a.size - 1)
    return wgrid * fs / (2 * math.pi), gd


# ---------------------------------------------------------------------------
# Steady-state initial conditions (coefficient-domain linear solves)
# ---------------------------------------------------------------------------

def lfilter_zi(b, a):
    """Initial filter state for step-response steady state
    (scipy.signal.lfilter_zi-compatible: solves (I - A^T) zi = B on the
    direct-form-II-transposed companion system, host f64)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    while a.size > 1 and a[0] == 0.0:
        a = a[1:]
    if a.size < 1:
        raise ValueError("at least one denominator coefficient required")
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(a.size, b.size)
    if n == 1:
        return np.zeros(0)
    a = np.concatenate([a, np.zeros(n - a.size)])
    b = np.concatenate([b, np.zeros(n - b.size)])
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:]
    if n > 2:
        comp[1:, :-1] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - comp.T, B)


def sosfilt_zi(sos):
    """Initial state per second-order section for step-response steady
    state (scipy.signal.sosfilt_zi-compatible): each section's lfilter_zi
    scaled by the cumulative DC gain of the sections before it."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    n = sos.shape[0]
    zi = np.empty((n, 2))
    scale = 1.0
    for k in range(n):
        bk, ak = sos[k, :3], sos[k, 3:]
        zi[k] = scale * lfilter_zi(bk, ak)
        scale *= bk.sum() / ak.sum()
    return zi


# ---------------------------------------------------------------------------
# Parks-McClellan equiripple FIR design (scipy.signal.remez parity)
# ---------------------------------------------------------------------------

def _pm_q(f, ftype):
    """Linear-phase structure factor Q(f) with H(f) = Q(f) * P(cos 2pi f).

    Type 1 (odd, sym): 1; type 2 (even, sym): cos(pi f);
    type 3 (odd, anti): sin(2pi f); type 4 (even, anti): sin(pi f).
    Evaluated with the true trig formula (signs matter for f > 1/2,
    where the coefficient-extraction IDFT samples it).
    """
    if ftype == 1:
        return np.ones_like(f)
    if ftype == 2:
        return np.cos(np.pi * f)
    if ftype == 3:
        return np.sin(2.0 * np.pi * f)
    return np.sin(np.pi * f)


def _pm_barycentric_weights(x):
    """Barycentric weights 1/prod_{j!=i}(x_i - x_j), log-stabilized.

    Only ratios of the weights ever enter the Remez formulas, so the
    common exp(max) factor is divided out — this keeps r ~ hundreds of
    near-collinear Chebyshev nodes from underflowing the raw products.
    """
    d = x[:, None] - x[None, :]
    np.fill_diagonal(d, 1.0)
    logw = -np.sum(np.log(np.abs(d)), axis=1)
    sign = np.prod(np.sign(d), axis=1)
    return sign * np.exp(logw - logw.max())


def _pm_eval(xq, xe, ce, we):
    """Evaluate the degree r-1 barycentric interpolant through
    (xe, ce) (r points, weights we) at query points xq."""
    diff = xq[:, None] - xe[None, :]
    hit = np.isclose(diff, 0.0, rtol=0.0, atol=1e-14)
    diff = np.where(hit, 1.0, diff)
    k = we[None, :] / diff
    num = k @ ce
    den = k.sum(axis=1)
    out = num / den
    row_hit = hit.any(axis=1)
    if row_hit.any():
        out[row_hit] = ce[hit[row_hit, :].argmax(axis=1)]
    return out


def remez(numtaps, bands, desired, *, weight=None, type="bandpass",
          maxiter=25, grid_density=16, fs=None):
    """Minimax (equiripple) FIR design by the Remez exchange algorithm
    (scipy.signal.remez-compatible).

    Implementation notes (independent of scipy's C code): the amplitude
    response is written H(f) = Q(f) P(cos 2pi f) per linear-phase type,
    the exchange runs on a dense grid in x = cos(2pi f) with
    log-stabilized barycentric interpolation, and the final coefficients
    come from sampling Q*P at the n roots of unity and one inverse DFT —
    no per-type reconstruction recursions. Reference: the reference
    project has no FIR design layer; parity target is
    scipy/signal/_fir_filter_design.py:remez (same grid-density
    semantics, same differentiator 1/f weighting).
    """
    import operator
    numtaps = operator.index(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be at least 3")
    if fs is None:
        fs = 1.0
    fs = float(fs)
    bands = np.asarray(bands, np.float64).ravel() / fs
    desired = np.asarray(desired, np.float64).ravel()
    if bands.size != 2 * desired.size:
        raise ValueError("bands must have exactly 2*len(desired) entries")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5:
        raise ValueError("bands must be monotonic in [0, fs/2]")
    if weight is None:
        weight = np.ones_like(desired)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != desired.size:
        raise ValueError("weight must have one entry per band")
    if type not in ("bandpass", "differentiator", "hilbert"):
        raise ValueError(f"invalid type {type!r}")
    sym = type == "bandpass"
    odd = numtaps % 2 == 1
    ftype = (1 if odd else 2) if sym else (3 if odd else 4)
    # number of cosine-basis coefficients of P
    if ftype == 1:
        r = (numtaps + 1) // 2
    elif ftype in (2, 4):
        r = numtaps // 2
    else:
        r = (numtaps - 1) // 2
    if r < 2:
        raise ValueError("numtaps too small for this filter type")

    nb = desired.size
    delf = 0.5 / (grid_density * r)
    # Q vanishes at f=0 for antisymmetric types and at f=1/2 for
    # types 2 and 3: pull the offending band edge inward by one grid
    # step (the classical Parks-McClellan edge snip).
    lo_cut = delf if ftype >= 3 else 0.0
    hi_cut = 0.5 - delf if ftype in (2, 3) else 0.5
    grid, dgrid, wgrid = [], [], []
    for b in range(nb):
        l, u = bands[2 * b], bands[2 * b + 1]
        l, u = max(l, lo_cut), min(u, hi_cut)
        if u < l:
            raise ValueError(
                f"band {b} collapses once the Q(f)=0 edge is removed")
        npts = max(2, int(round((u - l) / delf)) + 1) if u > l else 1
        g = np.linspace(l, u, npts)
        grid.append(g)
        if type == "differentiator":
            dgrid.append(desired[b] * g)
            if abs(desired[b]) >= 1e-4:
                # relative-error weighting on sloped bands (classical)
                wgrid.append(weight[b] / g)
            else:
                wgrid.append(np.full_like(g, weight[b]))
        else:
            dgrid.append(np.full_like(g, desired[b]))
            wgrid.append(np.full_like(g, weight[b]))
    seg_len = [g.size for g in grid]
    grid = np.concatenate(grid)
    dgrid = np.concatenate(dgrid)
    wgrid = np.concatenate(wgrid)
    q = _pm_q(grid, ftype)
    dgrid = dgrid / q
    wgrid = wgrid * q          # q >= 0 on [0, 1/2]
    x = np.cos(2.0 * np.pi * grid)
    ngrid = grid.size
    if ngrid < r + 1:
        raise ValueError("bands too narrow for this numtaps/grid_density")

    # band-segment boundaries: local-extremum detection must not look
    # across the gap between two bands
    seg_end = np.cumsum(seg_len)
    seg_start = seg_end - np.asarray(seg_len)

    ext = np.round(np.linspace(0, ngrid - 1, r + 1)).astype(int)
    ext = np.unique(ext)
    while ext.size < r + 1:     # duplicates from rounding on tiny grids
        missing = np.setdiff1d(np.arange(ngrid), ext)
        ext = np.sort(np.append(ext, missing[: r + 1 - ext.size]))

    delta = 0.0
    we_sub = ce = xe_sub = None
    for _ in range(maxiter):
        xe = x[ext]
        w = _pm_barycentric_weights(xe)
        alt = np.where(np.arange(r + 1) % 2 == 0, 1.0, -1.0)
        delta = (w @ dgrid[ext]) / np.sum(alt * w / wgrid[ext])
        ce_full = dgrid[ext] - alt * delta / wgrid[ext]
        # degree r-1 interpolant through the first r extremals; the
        # sub-barycentric weights fold in the dropped last node
        we_sub = w[:r] * (xe[:r] - xe[r])
        # keep the interpolation nodes WITH the coefficients built
        # from them: when maxiter exhausts, `ext` has already been
        # replaced by the next candidate set, and pairing the new
        # nodes with the old (ce, we_sub) yields a silently
        # inconsistent filter
        xe_sub = xe[:r]
        ce = ce_full[:r]
        err = wgrid * (_pm_eval(x, xe[:r], ce, we_sub) - dgrid)

        # candidate extremals: per-band-segment local maxima of |err|
        cand = []
        for s, e in zip(seg_start, seg_end):
            seg = err[s:e]
            n = seg.size
            if n == 1:
                cand.append(s)
                continue
            a = np.abs(seg)
            is_max = np.ones(n, bool)
            is_max[1:] &= a[1:] >= a[:-1]
            is_max[:-1] &= a[:-1] >= a[1:]
            idx = np.flatnonzero(is_max)
            # collapse flat plateaus to one representative
            keep = [idx[0]]
            for i in idx[1:]:
                if i == keep[-1] + 1 and a[i] == a[keep[-1]]:
                    continue
                keep.append(i)
            cand.extend(s + i for i in keep)
        # the current extremal nodes always alternate (E = -(-1)^i delta
        # there by construction), so including them guarantees >= r+1
        # alternating candidates even when delta ~ 0 makes the node
        # values too small to register as |E| maxima
        cand = np.union1d(np.asarray(cand), ext)
        # enforce sign alternation: of same-sign neighbours keep larger
        kept = [cand[0]]
        for i in cand[1:]:
            if np.sign(err[i]) == np.sign(err[kept[-1]]):
                if abs(err[i]) > abs(err[kept[-1]]):
                    kept[-1] = i
            else:
                kept.append(i)
        if len(kept) < r + 1:
            break               # converged (no spurious ripple left)
        # trim surplus while preserving alternation: drop endpoint pairs
        # (or the single smaller endpoint) with the smallest |err|
        while len(kept) > r + 1:
            if len(kept) - (r + 1) == 1:
                drop = 0 if abs(err[kept[0]]) < abs(err[kept[-1]]) else -1
                kept.pop(drop)
            else:
                if abs(err[kept[0]]) < abs(err[kept[-1]]):
                    kept.pop(0)
                else:
                    kept.pop(-1)
        new_ext = np.asarray(kept)
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext

    # coefficient extraction: sample A(f) = Q(f) P(cos 2pi f) at the n
    # roots of unity and inverse-DFT.  Conjugate symmetry of G is
    # automatic: Q's sign flip across f=1/2 cancels the phase factor's.
    n = numtaps
    m = (n - 1) / 2.0
    fj = np.arange(n) / n
    aj = _pm_q(fj, ftype) * _pm_eval(np.cos(2.0 * np.pi * fj),
                                     xe_sub, ce, we_sub)
    phase = np.exp(-2j * np.pi * fj * m)
    if not sym:
        phase = phase * 1j
    h = np.fft.ifft(aj * phase).real
    if ftype == 3:
        h[n // 2] = 0.0
    return h


def minimum_phase(h, method="homomorphic", n_fft=None, *, half=True):
    """Convert a linear-phase FIR filter to minimum phase
    (scipy.signal.minimum_phase-compatible).

    'homomorphic': real cepstrum folding (Oppenheim & Schafer eq 13.42b)
    — log-magnitude -> cepstrum -> causal fold -> exp.  With half=True
    the log-magnitude is halved first, giving a half-length filter whose
    magnitude is sqrt(|H|).  'hilbert': the Damera-Venkata/Evans optimal
    construction via the discrete Hilbert transform of the log spectrum
    (half-length only).  All math is host f64 at design time (module
    discipline), using numpy's FFT directly.
    """
    h = np.asarray(h)
    if np.iscomplexobj(h):
        raise ValueError("complex filters are not supported")
    if h.ndim != 1 or h.size <= 2:
        raise ValueError("h must be 1-D and at least 3 samples long")
    n = h.size
    n_half = n // 2
    if not np.allclose(h[-n_half:][::-1], h[:n_half],
                       rtol=1e-3, atol=1e-6):
        warnings.warn("h does not appear to be linear-phase symmetric; "
                      "minimum-phase conversion may fail", RuntimeWarning,
                      stacklevel=2)
    if method not in ("homomorphic", "hilbert"):
        raise ValueError(f"method must be 'homomorphic' or 'hilbert', "
                         f"got {method!r}")
    if method == "hilbert" and not half:
        raise ValueError("half=False requires method='homomorphic'")
    if n_fft is None:
        # epsilon = 2*n_stop/n_fft <= 0.01 with n_stop ~ n-1 (see scipy)
        n_fft = 2 ** int(math.ceil(math.log2(2 * (n - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < n:
        raise ValueError(f"n_fft must be at least len(h) == {n}")

    if method == "hilbert":
        # real part of H after centering the linear phase
        wshift = np.exp(2j * np.pi * np.arange(n_fft) * (n_half / n_fft))
        amp = (np.fft.fft(h, n_fft) * wshift).real
        dp = amp.max() - 1.0
        ds = -amp.min()
        scale = 4.0 / (math.sqrt(1 + dp + ds) + math.sqrt(1 - dp + ds)) ** 2
        mag = np.sqrt(np.maximum((amp + ds) * scale, 0.0)) + 1e-10
        # discrete Hilbert transform of log|H| -> minimum-phase phase
        sgn = np.zeros(n_fft)
        mid = n_fft // 2
        sgn[1:mid] = 1.0
        sgn[mid + 1:] = -1.0
        cep = np.fft.ifft(np.log(mag))
        h_min = np.fft.ifft(mag * np.exp(np.fft.fft(sgn * cep))).real
    else:
        mag = np.abs(np.fft.fft(h, n_fft))
        # regularize exact spectral zeros before the log; the specific
        # epsilon (1e-7 x smallest nonzero magnitude) deliberately matches
        # scipy.signal.minimum_phase so coefficients are bit-comparable in
        # the parity tests — any smaller floor changes the cepstrum tail
        mag += 1e-7 * mag[mag > 0].min()
        logmag = np.log(mag)
        if half:
            logmag *= 0.5
        cep = np.fft.ifft(logmag).real
        # causal fold: double positive quefrencies, zero negative ones
        win = np.zeros(n_fft)
        win[0] = 1.0
        win[1:n_fft // 2] = 2.0
        if n_fft % 2:
            win[n_fft // 2] = 1.0
        h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n_half + n % 2) if half else n
    return h_min[:n_out]


def firls(numtaps, bands, desired, *, weight=None, fs=None):
    """Least-squares linear-phase FIR design
    (scipy.signal.firls-compatible; odd numtaps, type I).

    Minimizes the integrated weighted squared error between the cosine-
    series amplitude A(nu) = sum c_k cos(pi k nu) and the piecewise-linear
    target over the specified bands.  The normal equations are assembled
    from closed-form band integrals of cos and nu*cos (Toeplitz + Hankel
    structure), solved in host f64 — same design-time discipline as the
    rest of the module.  Parity target:
    scipy/signal/_fir_filter_design.py:firls.
    """
    import operator
    numtaps = operator.index(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    if fs is None:
        fs = 2.0
    nyq = float(fs) / 2.0
    M = (numtaps - 1) // 2
    bands = np.asarray(bands, np.float64).ravel() / nyq
    desired = np.asarray(desired, np.float64).ravel()
    if bands.size % 2 or bands.size != desired.size:
        raise ValueError("bands and desired must both have an even "
                         "number of entries, one per band edge")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 1:
        raise ValueError("bands must be monotonic in [0, fs/2]")
    nb = bands.size // 2
    if weight is None:
        weight = np.ones(nb)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != nb:
        raise ValueError("weight must have one entry per band")

    def int_cos(m, l, u):
        """integral of cos(pi m nu) over [l, u] (vector over m)."""
        m = np.asarray(m, np.float64)
        out = np.empty_like(m)
        z = m == 0
        out[z] = u - l
        mn = m[~z] * np.pi
        out[~z] = (np.sin(mn * u) - np.sin(mn * l)) / mn
        return out

    def int_nu_cos(m, l, u):
        """integral of nu cos(pi m nu) over [l, u]."""
        m = np.asarray(m, np.float64)
        out = np.empty_like(m)
        z = m == 0
        out[z] = 0.5 * (u * u - l * l)
        mn = m[~z] * np.pi
        out[~z] = ((np.cos(mn * u) - np.cos(mn * l)) / mn ** 2
                   + (u * np.sin(mn * u) - l * np.sin(mn * l)) / mn)
        return out

    k = np.arange(M + 1)
    q = np.zeros(2 * M + 1)
    b = np.zeros(M + 1)
    for i in range(nb):
        l, u = bands[2 * i], bands[2 * i + 1]
        if u <= l:
            continue
        w = weight[i]
        q += w * int_cos(np.arange(2 * M + 1), l, u)
        d0, d1 = desired[2 * i], desired[2 * i + 1]
        slope = (d1 - d0) / (u - l)
        # D(nu) = d0 + slope*(nu - l)
        b += w * ((d0 - slope * l) * int_cos(k, l, u)
                  + slope * int_nu_cos(k, l, u))
    # Q_{jk} = (q_{|j-k|} + q_{j+k}) / 2
    Q = 0.5 * (q[np.abs(k[:, None] - k[None, :])] + q[k[:, None] + k[None, :]])
    try:
        c = np.linalg.solve(Q, b)
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(Q, b, rcond=None)[0]
    h = np.empty(numtaps)
    h[M] = c[0]
    h[M + 1:] = 0.5 * c[1:]
    h[:M] = h[M + 1:][::-1]
    return h


# ---------------------------------------------------------------------------
# Analog-prototype transforms in transfer-function form, analog response
# evaluation, and second-order notch/peak/comb designs
# (scipy parity targets: scipy/signal/_filter_design.py lp2lp/lp2hp/
# lp2bp/lp2bs, freqs, freqs_zpk, findfreqs, band_stop_obj and
# scipy/signal/_filter_design.py iirnotch/iirpeak/iircomb, iirdesign.
# The biquad notch/peak/comb formulas are the classical Orfanidis
# designs — "Introduction to Signal Processing", ch. 11 — which is also
# the derivation scipy documents.)
# ---------------------------------------------------------------------------


def _tf_arrays(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient arrays")
    return b, a


def lp2lp(b, a, wo: float = 1.0):
    """Lowpass prototype -> lowpass at cutoff ``wo`` (s -> s/wo),
    transfer-function form.

    Substituting s/wo into ``sum c_k s^k`` and clearing the common
    ``wo**d`` factor multiplies the coefficient of ``s^k`` by
    ``wo**(d-k)`` (d = max polynomial degree), which keeps the leading
    denominator coefficient's scale."""
    b, a = _tf_arrays(b, a)
    wo = float(wo)
    d, n = len(a), len(b)
    M = max(d, n)
    # substituting s/wo multiplies the coefficient of s^k by wo^-k; the
    # common factor is chosen so the SHORTER array's leading
    # coefficient keeps its scale (scipy's convention)
    pwo = wo ** np.arange(M - 1, -1, -1)
    start1 = max(n - d, 0)
    start2 = max(d - n, 0)
    return (b * pwo[start1] / pwo[start2:],
            a * pwo[start1] / pwo[start1:])


def lp2hp(b, a, wo: float = 1.0):
    """Lowpass prototype -> highpass at cutoff ``wo`` (s -> wo/s),
    transfer-function form.

    With highest-power-first coefficients, b[j] is the coefficient of
    s**(n-1-j); substituting wo/s and clearing the common s**(M-1)
    turns that term into ``b[j] * wo**(n-1-j) * s**(M-1-(n-1-j))`` —
    i.e. the coefficient array reverses, each entry scaled by wo**k,
    and pads with trailing zeros up to the common degree."""
    b, a = _tf_arrays(b, a)
    wo = float(wo)
    d, n = len(a), len(b)
    M = max(d, n)
    pwo = wo ** np.arange(M)
    bh = np.zeros(M)
    ah = np.zeros(M)
    bh[:n] = b[::-1] * pwo[:n]
    ah[:d] = a[::-1] * pwo[:d]
    return normalize(bh, ah)


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass (s -> (s^2 + wo^2)/(bw*s)),
    transfer-function form via exact polynomial composition."""
    b, a = _tf_arrays(b, a)
    wo, bw = float(wo), float(bw)
    d = max(len(a), len(b)) - 1
    num = _compose_tf(b, d, wo, bw, band="pass")
    den = _compose_tf(a, d, wo, bw, band="pass")
    return normalize(num, den)


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop (s -> bw*s/(s^2 + wo^2)),
    transfer-function form via exact polynomial composition."""
    b, a = _tf_arrays(b, a)
    wo, bw = float(wo), float(bw)
    d = max(len(a), len(b)) - 1
    num = _compose_tf(b, d, wo, bw, band="stop")
    den = _compose_tf(a, d, wo, bw, band="stop")
    return normalize(num, den)


def _compose_tf(c: np.ndarray, d: int, wo: float, bw: float,
                band: str) -> np.ndarray:
    """Compose polynomial ``sum c_k s^k`` (highest first, degree up to d)
    with the bandpass map s -> (s^2+wo^2)/(bw s) or the bandstop map
    s -> bw s/(s^2+wo^2), then clear the common denominator so the
    result is again a polynomial (degree 2d)."""
    quad = np.array([1.0, 0.0, wo * wo])       # s^2 + wo^2
    lin = np.array([bw, 0.0])                  # bw * s
    if band == "pass":
        top, bot = quad, lin
    else:
        top, bot = lin, quad
    # term k: c_k * top^k * bot^(d-k); k = power of s in the prototype
    out = np.zeros(1)
    n = len(c)
    for j in range(n):
        k = n - 1 - j
        term = np.array([c[j]])
        for _ in range(k):
            term = np.polymul(term, top)
        for _ in range(d - k):
            term = np.polymul(term, bot)
        out = np.polyadd(out, term)
    return out


def findfreqs(num, den, N: int, kind: str = "ba"):
    """Log-spaced frequency grid spanning the system's interesting range
    (scipy.signal.findfreqs-compatible heuristic: roughly half a decade
    beyond the outermost pole/zero down to a decade below the innermost).

    ``kind='ba'`` treats (num, den) as transfer-function coefficients;
    ``kind='zp'`` treats them as (zeros, poles) directly."""
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.atleast_1d(den))) + 0j
        tz = np.atleast_1d(np.roots(np.atleast_1d(num))) + 0j
    elif kind == "zp":
        ep = np.atleast_1d(den) + 0j
        tz = np.atleast_1d(num) + 0j
    else:
        raise ValueError(f"invalid kind {kind!r}")
    if len(ep) == 0:
        ep = np.atleast_1d(-1000.0) + 0j

    ez = np.concatenate((ep[ep.imag >= 0],
                         tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]))
    integ = np.abs(ez) < 1e-10
    hfreq = np.round(np.log10(np.max(3.0 * np.abs(ez.real + integ)
                                     + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(np.abs((ez + integ).real)
                                           + 2.0 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, N)


def freqs(b, a, worN=200, plot=None):
    """Analog filter frequency response H(jw) = B(jw)/A(jw)
    (scipy.signal.freqs-compatible)."""
    b, a = _tf_arrays(b, a)
    if worN is None:
        worN = 200
    if np.ndim(worN) == 0:
        w = findfreqs(b, a, int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    if plot is not None:
        plot(w, h)
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog frequency response from zeros/poles/gain
    (scipy.signal.freqs_zpk-compatible)."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    if worN is None:
        worN = 200
    if np.ndim(worN) == 0:
        w = findfreqs(z, p, int(worN), kind="zp")
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    num = k * np.prod(s[:, None] - z[None, :], axis=-1) if z.size else \
        np.full(w.shape, complex(k))
    den = np.prod(s[:, None] - p[None, :], axis=-1) if p.size else 1.0
    return w, num / den


def freqz_sos(sos, worN=512, whole: bool = False, fs=2 * math.pi):
    """Frequency response of cascaded second-order sections
    (scipy.signal.freqz_sos — the modern name for sosfreqz)."""
    return sosfreqz(sos, worN=worN, whole=whole, fs=fs)


def band_stop_obj(wp, ind: int, passb, stopb, gpass: float,
                  gstop: float, type: str):
    """Band-stop order objective for the movable passband edge
    (scipy.signal.band_stop_obj-compatible public surface over the
    internal objective the *ord functions minimize)."""
    kind = {"butter": "butter", "cheby": "cheby", "ellip": "ellip"}.get(type)
    if kind is None:
        raise ValueError(f"incorrect type: {type!r}")
    try:
        return _band_stop_obj(wp, ind, np.asarray(passb, np.float64),
                              np.asarray(stopb, np.float64), gpass,
                              gstop, kind)
    except ValueError:
        # infeasible edge position (acosh/log of an out-of-domain
        # selectivity): propagate nan like scipy so minimizers probing
        # the edge keep running
        warnings.warn("band_stop_obj: infeasible edge position "
                      "evaluates to nan", RuntimeWarning, stacklevel=2)
        return np.nan


def _notch_peak(w0: float, Q: float, fs: float, kind: str):
    fs = float(fs)
    w0 = 2.0 * float(w0) / fs          # normalized to Nyquist = 1
    if not 0 < w0 < 1:
        raise ValueError("w0 must be between 0 and fs/2")
    bw = w0 / float(Q) * math.pi       # -3 dB bandwidth in rad/sample
    w0 = w0 * math.pi
    if not 0 < bw < math.pi:
        raise ValueError("bandwidth w0/Q out of range")
    beta = math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if kind == "notch":
        b = gain * np.array([1.0, -2.0 * math.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * math.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0, Q, fs: float = 2.0):
    """Second-order IIR notch filter (scipy.signal.iirnotch-compatible):
    unit gain away from w0, zero at w0, -3 dB band of width w0/Q."""
    return _notch_peak(w0, Q, fs, "notch")


def iirpeak(w0, Q, fs: float = 2.0):
    """Second-order IIR peak (resonator) filter
    (scipy.signal.iirpeak-compatible): zero gain away from w0, unit
    gain at w0, -3 dB band of width w0/Q."""
    return _notch_peak(w0, Q, fs, "peak")


def iircomb(w0, Q, ftype: str = "notch", fs: float = 2.0, *,
            pass_zero: bool = False):
    """IIR comb filter with notches/peaks at multiples of w0
    (scipy.signal.iircomb-compatible).

    ``ftype='notch'`` rejects the harmonics, ``'peak'`` keeps only
    them; ``pass_zero`` moves the comb teeth from the harmonics of w0
    (False) to the midpoints between them (True)."""
    fs = float(fs)
    w0 = float(w0)
    if not 0 < w0 < fs / 2:
        raise ValueError("w0 must be between 0 and fs/2")
    if ftype not in ("notch", "peak"):
        raise ValueError(f"invalid ftype {ftype!r}")
    # the comb period must divide the sampling rate so the teeth land
    # exactly on the harmonics
    N = fs / w0
    if abs(N - round(N)) > 1e-9 * N:
        raise ValueError("fs must be divisible by w0")
    N = int(round(N))
    w_delta = 2.0 * math.pi * w0 / (float(Q) * fs)   # -3 dB width, rad
    beta = math.tan(N * w_delta / 4.0)
    # Orfanidis comb: G0 = passband gain, G = gain at the teeth
    if ftype == "notch":
        G0, G = 1.0, 0.0
    else:
        G0, G = 0.0, 1.0
    ax = 1.0 / (1.0 + beta)            # pole radius factor
    # teeth at harmonics of w0 (z^N = 1) unless pass_zero, which shifts
    # them to the anti-harmonics (z^N = -1)
    sign = -1.0 if not pass_zero else 1.0
    b = np.zeros(N + 1)
    a = np.zeros(N + 1)
    if ftype == "notch":
        b[0] = ax
        b[N] = sign * ax
        a[0] = 1.0
        a[N] = sign * (2.0 * ax - 1.0)
    else:
        b[0] = 1.0 - ax
        b[N] = sign * (1.0 - ax)
        a[0] = 1.0
        a[N] = -sign * (2.0 * ax - 1.0)
    return b, a


def iirdesign(wp, ws, gpass: float, gstop: float, analog: bool = False,
              ftype: str = "ellip", output: str = "ba", fs=None):
    """Complete IIR design from band-edge specs
    (scipy.signal.iirdesign-compatible): pick the minimum order with the
    matching *ord function, then design with :func:`iirfilter`."""
    try:
        ordfun = {"butter": buttord, "cheby1": cheb1ord,
                  "cheby2": cheb2ord, "ellip": ellipord}[
                      _FTYPES.get(ftype.lower(), ftype.lower())]
    except KeyError:
        raise ValueError(
            f"invalid ftype {ftype!r} for iirdesign (needs an order "
            "prediction rule: butter/cheby1/cheby2/ellip)") from None
    wp_arr = np.atleast_1d(np.asarray(wp, np.float64))
    ws_arr = np.atleast_1d(np.asarray(ws, np.float64))
    if wp_arr.shape != ws_arr.shape or wp_arr.size not in (1, 2):
        raise ValueError("wp and ws must both be scalars or both pairs")
    band = 2.0 * wp_arr / fs if fs is not None else wp_arr
    sband = 2.0 * ws_arr / fs if fs is not None else ws_arr
    if not analog:
        if np.any(band <= 0) or np.any(band >= 1) or \
                np.any(sband <= 0) or np.any(sband >= 1):
            raise ValueError("digital band edges must be 0 < w < fs/2")
    btype = _ord_btype(wp_arr, ws_arr)
    N, Wn = ordfun(wp, ws, gpass, gstop, analog=analog, fs=fs)
    return iirfilter(N, Wn, rp=gpass, rs=gstop, btype=btype,
                     analog=analog, ftype=ftype, output=output, fs=fs)


def _ord_btype(wp: np.ndarray, ws: np.ndarray) -> str:
    if wp.size == 1:
        return "lowpass" if wp[0] < ws[0] else "highpass"
    if wp[0] < ws[0] < ws[1] < wp[1]:
        return "bandstop"
    if ws[0] < wp[0] < wp[1] < ws[1]:
        return "bandpass"
    raise ValueError("passband and stopband edges must nest for a "
                     "band filter (wp inside ws or ws inside wp)")


# ---------------------------------------------------------------------------
# Partial-fraction expansion (scipy parity target:
# scipy/signal/_filter_design.py residue/residuez/invres/invresz/
# unique_roots). Residues at an m-fold pole come from the truncated
# power series of the deflated rational function about the pole — the
# Taylor/Laurent definition, computed by series division in f64.
# ---------------------------------------------------------------------------


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Cluster near-identical roots (scipy.signal.unique_roots-
    compatible): roots within ``tol`` of an existing group join it; the
    group is represented by its max/min/mean per ``rtype``."""
    if rtype in ("max", "maximum"):
        pick = np.max
    elif rtype in ("min", "minimum"):
        pick = np.min
    elif rtype in ("avg", "mean"):
        pick = np.mean
    else:
        raise ValueError(f"invalid rtype {rtype!r}")
    p = np.atleast_1d(np.asarray(p))
    groups: list[list] = []
    for root in p:
        for g in groups:
            if np.min(np.abs(np.asarray(g) - root)) < tol:
                g.append(root)
                break
        else:
            groups.append([root])
    uniq = np.array([pick(np.asarray(g)) for g in groups])
    mult = np.array([len(g) for g in groups])
    return uniq, mult


def _series_div(num: np.ndarray, den: np.ndarray, nterms: int) -> np.ndarray:
    """First nterms coefficients (lowest power first) of num/den as a
    power series; den[0] must be nonzero."""
    out = np.empty(nterms, np.result_type(num.dtype, den.dtype,
                                          np.complex128))
    num = np.concatenate([num, np.zeros(max(0, nterms - len(num)),
                                        num.dtype)])
    rem = num[:nterms].astype(out.dtype).copy()
    for i in range(nterms):
        c = rem[i] / den[0]
        out[i] = c
        take = min(nterms - i, len(den))
        rem[i:i + take] -= c * den[:take]
    return out


def _shifted(poly: np.ndarray, x0) -> np.ndarray:
    """Coefficients of P(x0 + u) in u, LOWEST power first (Taylor shift
    by synthetic division)."""
    c = np.asarray(poly, np.result_type(poly.dtype, type(x0),
                                        np.complex128)).copy()
    n = len(c)
    out = np.empty(n, c.dtype)
    for i in range(n):
        # one synthetic division by (x - x0): remainder = P_i(x0)
        for j in range(1, n - i):
            c[j] = c[j] + x0 * c[j - 1]
        out[i] = c[n - 1 - i]
        c = c[:n - 1 - i]
    return out


def _residues_at(num: np.ndarray, den_deflated: np.ndarray, pole,
                 mult: int) -> np.ndarray:
    """Residues [r_1, ..., r_mult] of num/(den_deflated*(x-pole)^mult)
    for terms 1/(x-pole)^1 ... ^mult: the series of num/den_deflated
    about the pole read in reverse."""
    ser = _series_div(_shifted(num, pole), _shifted(den_deflated, pole),
                      mult)
    return ser[::-1]


def _deflate(poly: np.ndarray, pole, mult: int) -> np.ndarray:
    """poly / (x - pole)^mult by synthetic division (exact root
    assumed; the remainder is dropped)."""
    c = np.asarray(poly, np.result_type(poly.dtype, type(pole),
                                        np.complex128))
    for _ in range(mult):
        q = np.empty(len(c) - 1, c.dtype)
        acc = 0.0 + 0.0j
        for i in range(len(c) - 1):
            acc = c[i] + pole * acc
            q[i] = acc
        c = q
    return c


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of B(s)/A(s)
    (scipy.signal.residue-compatible): returns (r, p, k) with repeated
    poles carrying consecutive residues for powers 1..m."""
    b = np.atleast_1d(np.asarray(b, np.result_type(np.asarray(b).dtype,
                                                   np.float64)))
    a = np.atleast_1d(np.asarray(a, np.result_type(np.asarray(a).dtype,
                                                   np.float64)))
    if np.all(b == 0) or b.size == 0:
        return (np.array([], complex), np.array([], complex),
                np.array([], np.float64))
    if a.size < 2:
        raise ValueError("denominator must have at least one root")
    # strip leading zeros; direct polynomial part by long division
    a = np.trim_zeros(a, "f")
    b = np.trim_zeros(b, "f")
    if len(b) >= len(a):
        k, b = np.polydiv(b, a)
    else:
        k = np.array([], np.result_type(b.dtype, a.dtype))
    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    r_all = []
    p_all = []
    for pj, m in zip(uniq, mult):
        den_rest = _deflate(a, pj, int(m))
        r_all.extend(_residues_at(b, den_rest, pj, int(m)))
        p_all.extend([pj] * int(m))
    return np.asarray(r_all), np.asarray(p_all), np.asarray(k)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residue` (scipy.signal.invres-compatible)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.array([])
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    a = np.array([1.0 + 0.0j])
    for pj, m in zip(uniq, mult):
        for _ in range(int(m)):
            a = np.polymul(a, np.array([1.0, -pj]))
    b = np.zeros(1, complex)
    idx = 0
    for pj, m in zip(uniq, mult):
        m = int(m)
        # a / (x-pj)^m, then multiply back (x-pj)^(m-j) per power j
        base = _deflate(a, pj, m)
        factor = np.array([1.0 + 0.0j])
        for j in range(m, 0, -1):
            # term r_idx(for power j) * base * (x-pj)^(m-j)
            b = np.polyadd(b, r[idx + j - 1] * np.polymul(base, factor))
            factor = np.polymul(factor, np.array([1.0, -pj]))
        idx += m
    if k.size:
        b = np.polyadd(b, np.polymul(k, a))
    b, a = _real_if_close(b), _real_if_close(a)
    return np.trim_zeros(np.atleast_1d(b), "f"), a


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of B(z^-1)/A(z^-1) in terms of
    ``r / (1 - p z^-1)^j`` (scipy.signal.residuez-compatible).

    Derivation: with w = z^-1 the transfer function is a rational
    function of w whose poles sit at w_i = 1/p_i; expanding in w and
    rewriting ``1/(w - w_i)^j = (-p_i)^j / (1 - p_i w)^j`` maps the
    w-residues onto the z^-1 convention."""
    b = np.atleast_1d(np.asarray(b)).astype(
        np.result_type(np.asarray(b).dtype, np.float64))
    a = np.atleast_1d(np.asarray(a)).astype(
        np.result_type(np.asarray(a).dtype, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] (the z^0 denominator coefficient) must "
                         "be nonzero")
    # polynomials in w = z^-1, coefficient i = power i (lowest first)
    bw = b[::-1]
    aw = a[::-1]
    bw = np.trim_zeros(bw, "f")
    aw = np.trim_zeros(aw, "f")
    if len(bw) >= len(aw):
        # direct part: division must produce the LOW-order tail in w;
        # scipy's k(z^-1) are the high powers of z^-1 — divide from the
        # high end in w, remainder keeps degree < deg(aw)
        kq, bw = np.polydiv(bw, aw)
        k = kq[::-1]
    else:
        k = np.array([])
    # poles in w (= 1/p); aw highest-first already
    wroots = np.roots(aw)
    uniq_w, mult = unique_roots(wroots, tol=tol, rtype=rtype)
    r_all = []
    p_all = []
    for wj, m in zip(uniq_w, mult):
        m = int(m)
        pj = 1.0 / wj
        den_rest = _deflate(aw, wj, m)
        cw = _residues_at(bw, den_rest, wj, m)   # powers 1..m in (w-wj)
        for j in range(1, m + 1):
            r_all.append(cw[j - 1] * (-pj) ** j)
            p_all.append(pj)
    return np.asarray(r_all), np.asarray(p_all), np.asarray(k)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residuez` (scipy.signal.invresz-compatible)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.array([])
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    # denominator prod (1 - p z^-1)^m, stored lowest power of z^-1 first
    a = np.array([1.0 + 0.0j])
    for pj, m in zip(uniq, mult):
        for _ in range(int(m)):
            # (1 - pj*w), coefficients lowest power of w = z^-1 first
            a = np.convolve(a, np.array([1.0, -pj]))
    b = np.zeros(1, complex)
    idx = 0
    for pj, m in zip(uniq, mult):
        m = int(m)
        # a(w) / (1 - pj w)^j  (series in w, exact division)
        for j in range(1, m + 1):
            term = a
            for _ in range(j):
                term = np.polydiv(term[::-1], np.array([-pj, 1.0]))[0][::-1]
            b = _polyadd_low(b, r[idx + j - 1] * term)
        idx += m
    k = np.trim_zeros(k, "b") if k.size else k   # drop zero high powers
    if k.size:
        b = _polyadd_low(b, np.convolve(k, a))
    b, a = _real_if_close(b), _real_if_close(a)
    return b, a


def _polyadd_low(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Add coefficient arrays stored lowest-power-first."""
    n = max(len(x), len(y))
    out = np.zeros(n, np.result_type(x.dtype, y.dtype))
    out[:len(x)] += x
    out[:len(y)] += y
    return out


def lfiltic(b, a, y, x=None):
    """Initial lfilter state reproducing a given past output/input
    history (scipy.signal.lfiltic-compatible).

    Derivation: unrolling the direct-form-II-transposed recurrence
    ``z_i[n] = b[i+1] x[n] - a[i+1] y[n] + z_{i+1}[n]`` backwards over
    the provided history gives
    ``zi[i] = sum_{k>=1} (b[i+k] x[-k] - a[i+k] y[-k])`` (a[0]-
    normalized; missing history is zero)."""
    b = np.atleast_1d(np.asarray(b, np.result_type(np.asarray(b).dtype,
                                                   np.float64)))
    a = np.atleast_1d(np.asarray(a, np.result_type(np.asarray(a).dtype,
                                                   np.float64)))
    while a.size > 1 and a[0] == 0.0:
        a = a[1:]
    if a.size < 1 or a[0] == 0.0:
        raise ValueError("the leading denominator coefficient must be "
                         "nonzero")
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = a.size - 1
    M = b.size - 1
    K = max(M, N)
    y = np.atleast_1d(np.asarray(y))
    x = (np.zeros(0, y.dtype) if x is None
         else np.atleast_1d(np.asarray(x)))
    rt = np.result_type(b.dtype, a.dtype, y.dtype,
                        x.dtype if x.size else np.float64)
    zi = np.zeros(K, rt)
    # y[-k] is y[k-1] in scipy's argument convention (most recent first)
    for i in range(K):
        acc = rt.type(0)
        for k in range(1, K - i + 1):
            if i + k <= M and k - 1 < x.shape[0]:
                acc = acc + b[i + k] * x[k - 1]
            if i + k <= N and k - 1 < y.shape[0]:
                acc = acc - a[i + k] * y[k - 1]
        zi[i] = acc
    return zi


def _erb(freq: float) -> float:
    """Equivalent rectangular bandwidth of the human auditory filter at
    ``freq`` Hz (Glasberg & Moore 1990)."""
    return 24.7 + freq / 9.26449


def gammatone(freq, ftype: str, order=None, numtaps=None, fs=None):
    """Gammatone auditory filter design
    (scipy.signal.gammatone-compatible).

    'fir': the sampled impulse response ``t^(order-1) e^{-2 pi b t}
    cos(2 pi f t)`` with b = 1.019 ERB(f), unit gain at ``freq``.
    'iir': the 8th-order digital IIR modeling a 4th-order gammatone —
    the Patterson-Holdsworth cascade of four 2nd-order sections
    (Slaney 1993): common pole pair ``e^{-BT} e^{+-i w T}`` four times,
    one real zero per section at ``e^{-BT}(cos wT +- sqrt(3 +- 2^1.5)
    sin wT)``, normalized to unit gain at the center frequency."""
    if fs is None:
        fs = 2.0
    fs = float(fs)
    freq = float(freq)
    if not 0 < freq < fs / 2:
        raise ValueError("freq must be between 0 and fs/2")
    if ftype == "fir":
        if order is None:
            order = 4
        order = int(order)
        if not 0 < order <= 24:
            raise ValueError("order must be within (0, 24]")
        if numtaps is None:
            numtaps = max(int(fs * 0.015), 15)
        numtaps = int(numtaps)
        t = np.arange(numtaps) / fs
        b_bw = 1.019 * _erb(freq)
        h = t ** (order - 1) * np.exp(-2 * np.pi * b_bw * t) * \
            np.cos(2 * np.pi * freq * t)
        # analytic unit-gain normalization: the continuous gammatone
        # envelope has peak spectral magnitude (order-1)!/(2 pi b)^order
        # and the cosine halves it; /fs converts the sampled sum to the
        # continuous integral
        scale = 2 * (2 * np.pi * b_bw) ** order / \
            math.factorial(order - 1) / fs
        return h * scale, np.ones(1)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    T = 1.0 / fs
    w = 2 * np.pi * freq
    B = 2 * np.pi * 1.019 * _erb(freq)
    ebt = np.exp(-B * T)
    cw, sw = np.cos(w * T), np.sin(w * T)
    # one second-order numerator per section: T (z^-1 - zk z^-2) form
    roots = [ebt * (cw + np.sqrt(3 + 2 ** 1.5) * sw),
             ebt * (cw - np.sqrt(3 + 2 ** 1.5) * sw),
             ebt * (cw + np.sqrt(3 - 2 ** 1.5) * sw),
             ebt * (cw - np.sqrt(3 - 2 ** 1.5) * sw)]
    b = np.array([1.0])
    for zk in roots:
        b = np.convolve(b, np.array([T, -T * zk]))
    a2 = np.array([1.0, -2 * ebt * cw, ebt * ebt])
    a = np.array([1.0])
    for _ in range(4):
        a = np.convolve(a, a2)
    # center-frequency gain: Slaney's closed form (Apple TR #35 /
    # MakeERBFilters) — scipy normalizes with this exact expression,
    # which differs from the numeric |H(e^{iwT})| in the last ~6 digits
    wT = w * T

    def _fac(s: float) -> complex:
        return (-2 * np.exp(2j * wT) * T
                + 2 * np.exp(-(B * T) + 1j * wT) * T * (cw + s * sw))

    s_lo = np.sqrt(3 - 2 ** 1.5)
    s_hi = np.sqrt(3 + 2 ** 1.5)
    gain = np.abs(
        _fac(-s_lo) * _fac(s_lo) * _fac(-s_hi) * _fac(s_hi)
        / (-2 / np.exp(2 * B * T) - 2 * np.exp(2j * wT)
           + 2 * (1 + np.exp(2j * wT)) / np.exp(B * T)) ** 4)
    return b / gain, a


def _bessel_j1(x: np.ndarray) -> np.ndarray:
    """Bessel J1 via the Abramowitz & Stegun 9.4 polynomial/asymptotic
    approximations (~1e-8 absolute) — enough for window design, no
    scipy.special dependency."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    small = ax < 3.0
    # |x| < 3: power-series polynomial in (x/3)^2
    t = (x / 3.0) ** 2
    p_small = x * (0.5 - t * (0.56249985 - t * (0.21093573 - t * (
        0.03954289 - t * (0.00443319 - t * (0.00031761
                                            - t * 0.00001109))))))
    # |x| >= 3: modulus/phase asymptotic form
    with np.errstate(divide="ignore", invalid="ignore"):
        u = 3.0 / np.where(ax > 0, ax, 1.0)
        f1 = (0.79788456 + u * (0.00000156 + u * (0.01659667 + u * (
            0.00017105 - u * (0.00249511 - u * (0.00113653
                                                - u * 0.00020033))))))
        th = (ax - 2.35619449 + u * (0.12499612 + u * (0.00005650 - u * (
            0.00637879 - u * (0.00074348 + u * (0.00079824
                                                - u * 0.00029166))))))
        p_big = np.sign(x) * f1 * np.cos(th) / np.sqrt(ax)
    return np.where(small, p_small, p_big)


def firwin_2d(hsize, window, *, fc=None, fs: float = 2.0,
              circular: bool = False, pass_zero=True, scale: bool = True):
    """2-D FIR filter design by the window method
    (scipy.signal.firwin_2d-compatible for the separable form).

    ``circular=False``: the separable product of two 1-D
    :func:`firwin` designs — coefficient-identical to scipy on the
    default arguments. Divergence note: scipy 1.17's separable path
    silently IGNORES ``pass_zero`` and ``scale`` (its output is always
    the scaled lowpass product, contradicting its own docstring); here
    both are honored by passing them through to :func:`firwin`, so
    ``pass_zero=False`` really produces zero gain along the frequency
    axes and ``scale=False`` really skips the unity normalization.
    ``circular=True``: the textbook circularly-symmetric design — the
    radially rotated 1-D window times the ideal circular-lowpass
    (jinc) impulse response ``fc J1(2 pi fc r)/r`` — normalized to
    unit DC gain. This also differs from scipy's current circular
    implementation (which radially interpolates the 1-D filter's TAPS
    over a +-1 grid — its output is not circularly-symmetric-lowpass
    shaped); the construction here is the classical Huang
    rotated-window method and measures as a real circular lowpass
    (unit DC gain, -52 dB stopband for a 33x33 hamming design)."""
    if len(hsize) != 2:
        raise ValueError("hsize must have exactly two elements")
    if fc is None:
        raise ValueError("fc is required")
    if not circular:
        if isinstance(window, str) or len(window) != 2:
            raise ValueError("window must be a 2-element tuple or list")
        win_r, win_c = window
        h_r = firwin(int(hsize[0]), fc, window=win_r, fs=fs,
                     pass_zero=pass_zero, scale=scale)
        h_c = firwin(int(hsize[1]), fc, window=win_c, fs=fs,
                     pass_zero=pass_zero, scale=scale)
        return np.outer(h_r, h_c)
    if hsize[0] != hsize[1]:
        raise ValueError("circular windows need square hsize")
    if np.ndim(fc) != 0 and np.size(fc) != 1:
        raise ValueError("circular firwin_2d needs a scalar fc "
                         "(multi-band radial designs are not defined)")
    if not isinstance(pass_zero, (bool, np.bool_)):
        raise ValueError("circular firwin_2d accepts only boolean "
                         "pass_zero")
    n = int(hsize[0])
    w1 = get_window(window, n, fftbins=False)
    c = (n - 1) / 2.0
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot(yy - c, xx - c)
    # rotate the 1-D window radially about its center
    win2 = np.interp(c + r, np.arange(n, dtype=np.float64), w1,
                     right=0.0)
    fc_n = float(np.atleast_1d(fc)[0]) / (fs / 2.0) / 2.0  # cycles/sample
    with np.errstate(divide="ignore", invalid="ignore"):
        jinc = np.where(r > 0,
                        fc_n * _bessel_j1(2 * np.pi * fc_n * r) / r,
                        np.pi * fc_n * fc_n)
    h = win2 * jinc
    if not pass_zero:
        # highpass: spectral inversion about the center sample
        delta = np.zeros_like(h)
        delta[int(c), int(c)] = 1.0 if n % 2 else 0.0
        h = (delta - h / h.sum()) if n % 2 else -h / h.sum()
        return h
    if scale:
        h = h / h.sum()
    return h
