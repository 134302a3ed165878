"""Filter design core (counterpart of the parts of ``tpufft/design.py`` the
multirate, IIR and sigtools layers call; scipy.signal semantics).

All coefficient math is float64 host numpy: O(N) scalar work on tiny
arrays that must be exact, so it never runs on the device. The layers that
run the designed filters (``iir``, ``multirate``, ``sigtools``) upload the
coefficients as constants.

Contents: the analog lowpass prototypes (``buttap``, ``cheb1ap``,
``cheb2ap``, ``ellipap`` on the Landen-transformation form of the Jacobi
elliptic functions, ``besselap``), the zpk frequency transforms and the
bilinear transform, ``iirfilter`` and its five wrappers, the
representation converters ``zpk2tf``/``normalize``/``tf2zpk``/
``zpk2sos``/``tf2sos``, the windowed-sinc ``firwin`` (on the port's
``windows.get_window``) with its Kaiser helpers, and the steady-state
initial conditions ``lfilter_zi``/``sosfilt_zi``.

``zpk2sos`` pairs each pole unit with the nearest zero unit and emits the
sections farthest-from-the-unit-circle poles first; its sections are
response-equivalent to scipy's, not byte-equal (sos factorizations are
not unique).
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from .windows import get_window

__all__ = [
    "BadCoefficients",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk", "bilinear_zpk",
    "iirfilter", "butter", "cheby1", "cheby2", "ellip", "bessel",
    "zpk2tf", "normalize", "tf2zpk", "zpk2sos", "tf2sos",
    "kaiser_beta", "kaiser_atten", "firwin",
    "lfilter_zi", "sosfilt_zi",
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
