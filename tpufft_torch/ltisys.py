"""Linear time-invariant systems (counterpart of ``tpufft/ltisys.py``;
scipy.signal semantics): representations, conversions, discretization,
simulation and frequency response.

* All representation and conversion math is host float64 numpy (tiny
  matrices that must be exact), as in the design layer.
* The matrix exponential (zoh/foh discretization, continuous ``lsim``) is
  a scaling-and-squaring Pade-13 (Higham 2005), with no scipy.linalg
  dependency.
* ``dlsim`` with a tensor input runs on the tensor's device: the state
  recurrence x[n+1] = A x[n] + B u[n] is ``iir._affine_scan``'s log-depth
  scan with the powers of A as host float64 constants, and the products
  with B, C and D are written out as sums (no matmul, so TF32 never
  touches them); numpy input stays on the exact host loop.
* The frequency responses reuse the design layer's ``freqs``/``freqz``;
  ``bode`` returns dB and degrees like scipy.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import design as _design
from .design import BadCoefficients
from .iir import _affine_scan

__all__ = [
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize",
    "cont2discrete", "expm",
    "lsim", "impulse", "step", "freqresp", "bode",
    "dlsim", "dimpulse", "dstep", "dfreqresp", "dbode",
    "place_poles", "BadCoefficients",
]


# ---------------------------------------------------------------------------
# Matrix exponential (Higham's scaling-and-squaring Pade-13)


_PADE13 = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
           1187353796428800.0, 129060195264000.0, 10559470521600.0,
           670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
           960960.0, 16380.0, 182.0, 1.0)


def expm(A):
    """Matrix exponential by scaling-and-squaring with a degree-13 Pade
    approximant (Higham 2005) — host f64, no scipy dependency."""
    A = np.asarray(A, np.float64 if not np.iscomplexobj(A)
                   else np.complex128)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("expm needs a square matrix")
    n = A.shape[0]
    if n == 0:
        return np.empty((0, 0), A.dtype)
    nrm = np.linalg.norm(A, 1)
    # scale so the Pade-13 approximant is in its accuracy region
    theta13 = 5.371920351148152
    s = max(0, int(math.ceil(math.log2(nrm / theta13))) if nrm > theta13
            else 0)
    As = A / (2.0 ** s)
    b = _PADE13
    I = np.eye(n, dtype=As.dtype)
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U = As @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
              + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I)
    R = np.linalg.solve(V - U, V + U)
    for _ in range(s):
        R = R @ R
    return R


# ---------------------------------------------------------------------------
# Representation conversions


def tf2ss(num, den):
    """Transfer function -> controller-canonical state space
    (scipy.signal.tf2ss-compatible shapes and ordering)."""
    num = np.atleast_2d(np.asarray(num, np.float64))
    den = np.atleast_1d(np.asarray(den, np.float64))
    if den.size == 0 or np.all(den == 0) or den[0] == 0:
        raise ValueError("denominator must have a nonzero leading "
                         "coefficient")
    num = num / den[0]
    den = den / den[0]
    K = den.size
    M = num.shape[1]
    if M > K:
        raise ValueError("improper transfer function: numerator order "
                         "exceeds denominator order")
    # left-pad num to the denominator length so num[:, 0] is the direct
    # feedthrough coefficient
    num = np.hstack((np.zeros((num.shape[0], K - M)), num))
    if K == 1:
        return (np.zeros((0, 0)), np.zeros((0, 1)),
                np.zeros((num.shape[0], 0)), num.copy())
    D = num[:, :1].copy()
    n = K - 1
    A = np.zeros((n, n))
    A[0, :] = -den[1:]
    if n > 1:
        A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = num[:, 1:] - num[:, :1] * den[None, 1:]
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space -> transfer function (scipy.signal.ss2tf-compatible:
    den from the characteristic polynomial, num rows per output)."""
    A, B, C, D = abcd_normalize(A, B, C, D)
    if not 0 <= input < B.shape[1]:
        raise ValueError("System does not have the input specified")
    B = B[:, input:input + 1]
    D = D[:, input:input + 1]
    den = np.poly(A) if A.size else np.ones(1)
    nout = D.shape[0]
    if B.size == 0 and C.size == 0:
        num = D.reshape(nout, 1)
        return num, den
    num = np.empty((nout, den.size))
    for k in range(nout):
        Ck = np.atleast_2d(C[k, :])
        num[k] = np.poly(A - B @ Ck) + (D[k, 0] - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """Zeros/poles/gain -> state space (via the transfer function,
    scipy.signal.zpk2ss-compatible)."""
    return tf2ss(*_design.zpk2tf(z, p, k))


def ss2zpk(A, B, C, D, input: int = 0):
    """State space -> zeros/poles/gain (scipy.signal.ss2zpk-compatible,
    with the BadCoefficients leading-zero strip of tf2zpk)."""
    num, den = ss2tf(A, B, C, D, input=input)
    return _tf2zpk_rows(num, den)


def _tf2zpk_rows(num, den):
    num = np.atleast_2d(num)
    if num.shape[0] == 1:
        return _design.tf2zpk(num[0], den)
    return _design.tf2zpk(num, den)


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in compatible zero matrices for missing state-space parts
    and validate dimensions (scipy.signal.abcd_normalize-compatible)."""
    A = None if A is None else np.atleast_2d(np.asarray(A, np.float64))
    B = None if B is None else np.atleast_2d(np.asarray(B, np.float64))
    C = None if C is None else np.atleast_2d(np.asarray(C, np.float64))
    D = None if D is None else np.atleast_2d(np.asarray(D, np.float64))
    # infer dimensions
    n = None   # states
    m = None   # inputs
    p = None   # outputs
    if A is not None:
        if A.shape[0] != A.shape[1]:
            raise ValueError("A must be square")
        n = A.shape[0]
    if B is not None:
        n = B.shape[0] if n is None else n
        m = B.shape[1]
        if B.shape[0] != n:
            raise ValueError("A and B must have the same number of rows")
    if C is not None:
        n = C.shape[1] if n is None else n
        p = C.shape[0]
        if C.shape[1] != n:
            raise ValueError("A and C must have the same number of "
                             "columns")
    if D is not None:
        p = D.shape[0] if p is None else p
        m = D.shape[1] if m is None else m
        if D.shape[0] != p or D.shape[1] != m:
            raise ValueError("D dimensions are inconsistent")
    if n is None or m is None or p is None:
        raise ValueError("not enough information to determine system "
                         "dimensions")
    A = np.zeros((n, n)) if A is None else A
    B = np.zeros((n, m)) if B is None else B
    C = np.zeros((p, n)) if C is None else C
    D = np.zeros((p, m)) if D is None else D
    return A, B, C, D


# ---------------------------------------------------------------------------
# Discretization


def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Continuous -> discrete LTI transformation
    (scipy.signal.cont2discrete-compatible: gbt/bilinear/euler/
    backward_diff/zoh/foh/impulse; tuple in, matching tuple + dt out)."""
    if _is_lti(system):
        if system.dt is not None:
            raise ValueError("system is already discrete")
        ss = system.to_ss()
        ad, bd, cd, dd, _ = cont2discrete(
            (ss.A, ss.B, ss.C, ss.D), dt, method=method, alpha=alpha)
        out = StateSpace(ad, bd, cd, dd, dt=dt)
        # preserve the caller's representation class, like scipy
        if isinstance(system, TransferFunction):
            return out.to_tf()
        if isinstance(system, ZerosPolesGain):
            return out.to_zpk()
        return out
    if len(system) == 2:
        sysd = cont2discrete(tf2ss(*system), dt, method=method,
                             alpha=alpha)
        return ss2tf(*sysd[:4]) + (dt,)
    if len(system) == 3:
        sysd = cont2discrete(zpk2ss(*system), dt, method=method,
                             alpha=alpha)
        return ss2zpk(*sysd[:4]) + (dt,)
    if len(system) != 4:
        raise ValueError("system must be (num, den), (z, p, k) or "
                         "(A, B, C, D)")
    a, b, c, d = map(lambda M: np.atleast_2d(np.asarray(M, np.float64)),
                     system)
    n = a.shape[0]
    if method == "gbt":
        if alpha is None:
            raise ValueError("alpha parameter is required for gbt method")
        if not 0 <= alpha <= 1:
            raise ValueError("alpha must be within [0, 1]")
    elif method == "bilinear" or method == "tustin":
        method, alpha = "gbt", 0.5
    elif method == "euler" or method == "forward_diff":
        method, alpha = "gbt", 0.0
    elif method == "backward_diff":
        method, alpha = "gbt", 1.0

    if method == "gbt":
        ima = np.eye(n) - alpha * dt * a
        ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * a)
        bd = np.linalg.solve(ima, dt * b)
        cd = np.linalg.solve(ima.T, c.T).T
        dd = d + alpha * (c @ bd)
    elif method == "zoh":
        em = np.zeros((n + b.shape[1], n + b.shape[1]))
        em[:n, :n] = a * dt
        em[:n, n:] = b * dt
        ms = expm(em)
        ad = ms[:n, :n]
        bd = ms[:n, n:]
        cd = c.copy()
        dd = d.copy()
    elif method == "foh":
        # first-order hold: triangular input interpolation (the
        # standard block-exponential construction)
        nb = b.shape[1]
        em = np.zeros((n + 2 * nb, n + 2 * nb))
        em[:n, :n] = a * dt
        em[:n, n:n + nb] = b * dt
        em[n:n + nb, n + nb:] = np.eye(nb)
        ms = expm(em)
        phi = ms[:n, :n]
        gamma1 = ms[:n, n:n + nb]
        gamma2 = ms[:n, n + nb:]
        ad = phi
        bd = gamma1 + phi @ gamma2 - gamma2
        cd = c.copy()
        dd = d + c @ gamma2
    elif method == "impulse":
        if not np.allclose(d, 0):
            raise ValueError("impulse method is only applicable to "
                             "strictly proper systems")
        ad = expm(a * dt)
        bd = ad @ b * dt
        cd = c.copy()
        dd = (c @ b) * dt
    else:
        raise ValueError(f"unknown transformation method {method!r}")
    return ad, bd, cd, dd, dt


# ---------------------------------------------------------------------------
# System classes


def _is_lti(obj) -> bool:
    return isinstance(obj, _LTIBase)


class _LTIBase:
    """Shared representation plumbing for continuous/discrete systems
    (subclasses store their native form and set ``_dt``)."""

    @property
    def dt(self):
        return self._dt

    # conversion helpers -----------------------------------------------
    def to_tf(self):
        num, den = self._as_tf()
        return TransferFunction(num, den, dt=self._dt)

    def to_zpk(self):
        z, p, k = self._as_zpk()
        return ZerosPolesGain(z, p, k, dt=self._dt)

    def to_ss(self):
        return StateSpace(*self._as_ss(), dt=self._dt)

    # scipy-compatible convenience methods -----------------------------
    def impulse(self, X0=None, T=None, N=None):
        if self._dt is None:
            return impulse(self, X0=X0, T=T, N=N)
        return dimpulse(self, x0=X0, t=T, n=N)

    def step(self, X0=None, T=None, N=None):
        if self._dt is None:
            return step(self, X0=X0, T=T, N=N)
        return dstep(self, x0=X0, t=T, n=N)

    def output(self, U, T, X0=None):
        if self._dt is None:
            return lsim(self, U, T, X0=X0)
        return dlsim(self, U, t=T, x0=X0)

    def freqresp(self, w=None, n: int = 10000):
        if self._dt is None:
            return freqresp(self, w=w, n=n)
        return dfreqresp(self, w=w, n=n)

    def bode(self, w=None, n: int = 100):
        if self._dt is None:
            return bode(self, w=w, n=n)
        return dbode(self, w=w, n=n)

    def __repr__(self):
        kind = "dt: {}".format(self._dt) if self._dt is not None \
            else "continuous-time"
        return f"{type(self).__name__}({self._describe()}, {kind})"


class TransferFunction(_LTIBase):
    """Transfer-function system (scipy.signal.TransferFunction-
    compatible surface: num/den properties, conversions, simulation and
    response methods; ``dt`` makes it discrete)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and _is_lti(system[0]):
            other = system[0].to_tf()
            system = (other.num, other.den)
            dt = other.dt if dt is None else dt
        if len(system) != 2:
            raise ValueError("TransferFunction needs (num, den)")
        num = np.asarray(system[0])
        if num.ndim == 2 and num.shape[0] == 1:
            num = num[0]          # single-output row, scipy-style
        if num.ndim <= 1:
            num, den = _design.normalize(num, system[1])
        else:
            den = np.atleast_1d(np.asarray(system[1], np.float64))
            num = np.atleast_2d(np.asarray(num, np.float64))
        self.num = np.atleast_1d(num)
        self.den = np.atleast_1d(den)
        self._dt = dt

    def _describe(self):
        return f"num={self.num!r}, den={self.den!r}"

    def _as_tf(self):
        return self.num, self.den

    def _as_zpk(self):
        return _design.tf2zpk(self.num, self.den)

    def _as_ss(self):
        return tf2ss(self.num, self.den)

    @property
    def zeros(self):
        return self._as_zpk()[0]

    @property
    def poles(self):
        return self._as_zpk()[1]


class ZerosPolesGain(_LTIBase):
    """Zeros/poles/gain system (scipy.signal.ZerosPolesGain-compatible
    surface)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and _is_lti(system[0]):
            other = system[0].to_zpk()
            system = (other.zeros, other.poles, other.gain)
            dt = other.dt if dt is None else dt
        if len(system) != 3:
            raise ValueError("ZerosPolesGain needs (z, p, k)")
        self.zeros = np.atleast_1d(np.asarray(system[0]))
        self.poles = np.atleast_1d(np.asarray(system[1]))
        # keep complex gains (scipy does); collapse numerically-real
        # complex to float
        self.gain = np.real_if_close(np.asarray(system[2])).item()
        self._dt = dt

    def _describe(self):
        return (f"zeros={self.zeros!r}, poles={self.poles!r}, "
                f"gain={self.gain!r}")

    def _as_tf(self):
        return _design.zpk2tf(self.zeros, self.poles, self.gain)

    def _as_zpk(self):
        return self.zeros, self.poles, self.gain

    def _as_ss(self):
        return zpk2ss(self.zeros, self.poles, self.gain)


class StateSpace(_LTIBase):
    """State-space system (scipy.signal.StateSpace-compatible
    surface)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and _is_lti(system[0]):
            other = system[0].to_ss()
            system = (other.A, other.B, other.C, other.D)
            dt = other.dt if dt is None else dt
        if len(system) != 4:
            raise ValueError("StateSpace needs (A, B, C, D)")
        self.A, self.B, self.C, self.D = abcd_normalize(*system)
        self._dt = dt

    def _describe(self):
        return (f"A={self.A!r}, B={self.B!r}, C={self.C!r}, "
                f"D={self.D!r}")

    def _abcd(self):
        return self.A, self.B, self.C, self.D

    def _as_tf(self):
        return ss2tf(self.A, self.B, self.C, self.D)

    def _as_zpk(self):
        return ss2zpk(self.A, self.B, self.C, self.D)

    def _as_ss(self):
        return self.A, self.B, self.C, self.D

    @property
    def zeros(self):
        return self._as_zpk()[0]

    @property
    def poles(self):
        return self._as_zpk()[1]


def lti(*system):
    """Continuous-time LTI factory (scipy.signal.lti-compatible):
    2 args -> TransferFunction, 3 -> ZerosPolesGain, 4 -> StateSpace."""
    n = len(system)
    if n == 2:
        return TransferFunction(*system)
    if n == 3:
        return ZerosPolesGain(*system)
    if n == 4:
        return StateSpace(*system)
    raise ValueError(f"{n} args: needs 2 (tf), 3 (zpk) or 4 (ss)")


def dlti(*system, dt=True):
    """Discrete-time LTI factory (scipy.signal.dlti-compatible; dt
    defaults to True = unspecified-but-discrete, like scipy)."""
    n = len(system)
    if n == 2:
        return TransferFunction(*system, dt=dt)
    if n == 3:
        return ZerosPolesGain(*system, dt=dt)
    if n == 4:
        return StateSpace(*system, dt=dt)
    raise ValueError(f"{n} args: needs 2 (tf), 3 (zpk) or 4 (ss)")


def _to_ss(system, discrete: bool):
    """Coerce a tuple or class instance to StateSpace matrices (+ dt
    for the discrete flavor)."""
    if _is_lti(system):
        if discrete and system.dt is None:
            raise ValueError("a continuous-time system cannot be used "
                             "with the discrete-time functions")
        if not discrete and system.dt is not None:
            raise ValueError("a discrete-time system cannot be used "
                             "with the continuous-time functions")
        ss = system.to_ss()
        return (ss.A, ss.B, ss.C, ss.D), (system.dt if discrete else None)
    n = len(system)
    dt = None
    if discrete:
        *system, dt = system
        n -= 1
    if n == 2:
        abcd = tf2ss(*system)
    elif n == 3:
        abcd = zpk2ss(*system)
    elif n == 4:
        abcd = abcd_normalize(*system)
    else:
        raise ValueError("system must be an lti instance or a 2/3/4-"
                         "tuple (+ dt for discrete)")
    return abcd, dt


# ---------------------------------------------------------------------------
# Discrete simulation


def _interp_rows(tout: np.ndarray, ts: np.ndarray, u: torch.Tensor):
    """``np.interp(tout, ts, u[:, j])`` for every column of the tensor u,
    on u's device: the brackets and weights are host float64 (they depend
    only on the two time grids), the gather and the blend run where u
    lies."""
    if ts.size == 1:
        return u[:1].expand(tout.size, u.shape[1])
    lo = np.clip(np.searchsorted(ts, tout, side="right") - 1, 0,
                 ts.size - 2)
    frac = np.clip((tout - ts[lo]) / (ts[lo + 1] - ts[lo]), 0.0, 1.0)
    lo_t = torch.as_tensor(lo, device=u.device)
    fr = torch.as_tensor(frac, dtype=u.dtype, device=u.device)[:, None]
    return torch.lerp(u[lo_t], u[lo_t + 1], fr)


def _dlsim_tensor(A, B, C, D, u: torch.Tensor, x0):
    """x[k+1] = A x[k] + B u[k], y[k] = C x[k] + D u[k] for the tensor u
    (n, inputs) on its device, in its dtype: the offsets B u[k] and the
    outputs are written out as sums over the inputs and states, and the
    states are ``iir._affine_scan``'s log-depth scan with the powers of A
    as host float64 constants — never a matmul, so TF32 cannot touch the
    recurrence."""
    n, nin = u.shape
    nst = A.shape[0]
    dev, dt = u.device, u.dtype
    x0 = np.zeros(nst) if x0 is None else \
        np.asarray(x0, np.float64).reshape(nst)
    cols = u.unbind(1)

    def combine(M, planes, i):
        acc = None
        for j, p in enumerate(planes):
            if M[i, j] != 0.0:
                acc = p * float(M[i, j]) if acc is None else \
                    acc.add(p, alpha=float(M[i, j]))
        return acc

    states = [torch.full((n,), float(x0[i]), dtype=dt, device=dev)
              for i in range(nst)]
    if nst and n > 1:
        zero = torch.zeros(n - 1, dtype=dt, device=dev)
        offs = []
        for i in range(nst):
            o = combine(B, [c[:-1] for c in cols], i)
            offs.append((zero if o is None else o)[None])
        zi = [torch.full((1,), float(x0[i]), dtype=dt, device=dev)
              for i in range(nst)]
        z = _affine_scan(offs, zi, np.asarray(A, np.float64))
        for i in range(nst):
            states[i][1:] = z[i][0]
    ys = []
    for o in range(C.shape[0]):
        y = combine(np.hstack([C, D]), states + list(cols), o)
        ys.append(torch.zeros(n, dtype=dt, device=dev) if y is None else y)
    xs = torch.stack(states, 1) if nst else \
        torch.zeros((n, 0), dtype=dt, device=dev)
    return torch.stack(ys, 1), xs


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete-time system (scipy.signal.dlsim-compatible:
    returns (tout, yout, xout) for state-space input, (tout, yout)
    otherwise).

    Numpy input runs the exact host recurrence in float64. A tensor u
    runs on its device in its dtype (float32 and float64; other dtypes in
    float32), and yout and xout are tensors there: the recurrence
    x[n+1] = A x[n] + B u[n] is ``iir._affine_scan``'s log-depth scan
    (``_dlsim_tensor``). With ``t`` given, u is interpolated onto the dt
    grid on its device, as scipy does on the host."""
    is_ss_input = _is_lti(system) and isinstance(system, StateSpace) \
        or (not _is_lti(system) and len(system) == 5)
    (A, B, C, D), dt = _to_ss(system, discrete=True)
    dt = 1.0 if dt is None or dt is True else float(dt)
    is_dev = isinstance(u, torch.Tensor)
    if is_dev:
        u = torch.atleast_1d(u)
        if u.dtype not in (torch.float32, torch.float64):
            u = u.to(torch.float32)
    else:
        u = np.atleast_1d(u)
    if u.ndim == 1:
        u = u.reshape(-1, 1)
    n_steps = u.shape[0]
    tout = np.linspace(0, (n_steps - 1) * dt, n_steps) if t is None \
        else np.asarray(t)
    if t is not None:
        n_steps = int(np.floor(tout[-1] / dt)) + 1
        ts = tout
        tout = np.arange(n_steps) * dt
        # sample-and-hold u onto the dt grid like scipy (interp)
        if is_dev:
            u = _interp_rows(tout, ts, u)
        else:
            un = np.asarray(u, np.float64)
            u = np.column_stack([np.interp(tout, ts, un[:, j])
                                 for j in range(un.shape[1])])
    nst = A.shape[0]
    if is_dev:
        ys, xs = _dlsim_tensor(A, B, C, D, u, x0)
        if is_ss_input:
            return tout, ys, xs
        return tout, ys
    u = np.asarray(u, np.float64)
    xout = np.zeros((n_steps, nst))
    if x0 is not None:
        xout[0] = np.asarray(x0, np.float64).reshape(nst)
    yout = np.zeros((n_steps, C.shape[0]))
    for i in range(n_steps):
        yout[i] = C @ xout[i] + D @ u[i]
        if i + 1 < n_steps:
            xout[i + 1] = A @ xout[i] + B @ u[i]
    if is_ss_input:
        return tout, yout, xout
    return tout, yout


def _d_default_n(system, n):
    if n is None:
        n = 100
    return int(n)


def dimpulse(system, x0=None, t=None, n=None):
    """Discrete impulse response (scipy.signal.dimpulse-compatible:
    yout is a tuple with one array per input)."""
    (A, B, C, D), dt = _to_ss(system, discrete=True)
    dt = 1.0 if dt is None or dt is True else float(dt)
    n = _d_default_n(system, n) if t is None else len(np.atleast_1d(t))
    tout = np.arange(n) * dt if t is None else np.asarray(t)
    youts = []
    for j in range(B.shape[1]):
        u = np.zeros((n, B.shape[1]))
        u[0, j] = 1.0
        out = dlsim((A, B, C, D, dt), u, x0=x0)
        youts.append(out[1])
    return tout, tuple(youts)


def dstep(system, x0=None, t=None, n=None):
    """Discrete step response (scipy.signal.dstep-compatible)."""
    (A, B, C, D), dt = _to_ss(system, discrete=True)
    dt = 1.0 if dt is None or dt is True else float(dt)
    n = _d_default_n(system, n) if t is None else len(np.atleast_1d(t))
    tout = np.arange(n) * dt if t is None else np.asarray(t)
    youts = []
    for j in range(B.shape[1]):
        u = np.zeros((n, B.shape[1]))
        u[:, j] = 1.0
        out = dlsim((A, B, C, D, dt), u, x0=x0)
        youts.append(out[1])
    return tout, tuple(youts)


# ---------------------------------------------------------------------------
# Continuous simulation


def lsim(system, U, T, X0=None, interp: bool = True):
    """Simulate a continuous-time system on an equally spaced time grid
    (scipy.signal.lsim-compatible): exact zero-order-hold (interp=False)
    or linear-interpolation (first-order-hold, interp=True) stepping via
    one block matrix exponential."""
    (A, B, C, D), _ = _to_ss(system, discrete=False)
    T = np.atleast_1d(np.asarray(T, np.float64))
    if T.ndim != 1:
        raise ValueError("T must be 1-D")
    n_steps = T.size
    nst = A.shape[0]
    nin = B.shape[1]
    x0 = np.zeros(nst) if X0 is None else \
        np.asarray(X0, np.float64).reshape(nst)
    if U is None or (np.ndim(U) == 0 and U == 0):
        U = np.zeros((n_steps, nin))
    U = np.atleast_1d(np.asarray(U, np.float64))
    if U.ndim == 1:
        U = U.reshape(-1, 1)
    if U.shape[0] != n_steps:
        raise ValueError("U must have as many rows as T has elements")
    if n_steps == 1:
        y = x0 @ C.T + U[0] @ D.T
        return T, np.squeeze(y), x0.reshape(1, -1)
    dt = T[1] - T[0]
    if not np.allclose(np.diff(T), dt):
        raise ValueError("T must be equally spaced")
    xout = np.empty((n_steps, nst))
    xout[0] = x0
    if nst:
        if not interp:
            em = np.zeros((nst + nin, nst + nin))
            em[:nst, :nst] = A * dt
            em[:nst, nst:] = B * dt
            ms = expm(em)
            Ad = ms[:nst, :nst]
            Bd = ms[:nst, nst:]
            for i in range(1, n_steps):
                xout[i] = Ad @ xout[i - 1] + Bd @ U[i - 1]
        else:
            # linear interpolation of the input over each step — the
            # same Gamma1/Gamma2 block-exponential construction as
            # cont2discrete's validated 'foh' method:
            # x[i+1] = Phi x[i] + Gamma1 u[i] + Gamma2 (u[i+1] - u[i])
            em = np.zeros((nst + 2 * nin, nst + 2 * nin))
            em[:nst, :nst] = A * dt
            em[:nst, nst:nst + nin] = B * dt
            em[nst:nst + nin, nst + nin:] = np.eye(nin)
            ms = expm(em)
            Ad = ms[:nst, :nst]
            G1 = ms[:nst, nst:nst + nin]
            G2 = ms[:nst, nst + nin:]
            for i in range(1, n_steps):
                xout[i] = (Ad @ xout[i - 1] + G1 @ U[i - 1]
                           + G2 @ (U[i] - U[i - 1]))
    yout = xout @ C.T + U @ D.T
    return T, np.squeeze(yout), xout


def impulse(system, X0=None, T=None, N=None):
    """Continuous impulse response (scipy.signal.impulse-compatible):
    simulate with x0 = B (+ X0) and zero input."""
    (A, B, C, D), _ = _to_ss(system, discrete=False)
    if T is None:
        T = _default_response_times(A, 100 if N is None else int(N))
    else:
        T = np.asarray(T, np.float64)
    x0 = B.ravel() if X0 is None else B.ravel() + \
        np.asarray(X0, np.float64).ravel()
    U = np.zeros((T.size, B.shape[1]))
    _, y, _ = lsim((A, B, C, D), U, T, X0=x0)
    return T, y


def step(system, X0=None, T=None, N=None):
    """Continuous step response (scipy.signal.step-compatible)."""
    (A, B, C, D), _ = _to_ss(system, discrete=False)
    if T is None:
        T = _default_response_times(A, 100 if N is None else int(N))
    else:
        T = np.asarray(T, np.float64)
    U = np.ones((T.size, B.shape[1]))
    _, y, _ = lsim((A, B, C, D), U, T, X0=X0)
    return T, y


def _default_response_times(A, n: int):
    """scipy's heuristic: 7 slowest-pole time constants, n points."""
    if A.size == 0:
        return np.linspace(0, 1.0, n)
    vals = np.linalg.eigvals(A)
    r = np.min(np.abs(np.real(vals)))
    if r == 0:
        r = 1.0
    tc = 1.0 / r
    return np.linspace(0.0, 7 * tc, n)


# ---------------------------------------------------------------------------
# Frequency response


def freqresp(system, w=None, n: int = 10000):
    """Continuous frequency response H(jw)
    (scipy.signal.freqresp-compatible)."""
    if _is_lti(system):
        if system.dt is not None:
            raise ValueError("freqresp needs a continuous-time system")
        num, den = system._as_tf()
    else:
        num, den = _tuple_to_tf(system)
    num = _single_output_num(num)
    if w is not None:
        w = np.asarray(w, np.float64)
        _, h = _design.freqs(num, den, worN=w)
    else:
        w, h = _design.freqs(num, den, worN=int(n))
    return w, h


def _single_output_num(num):
    """Frequency response is defined for single-output systems only
    (scipy raises for MIMO instead of silently answering for output
    0)."""
    num = np.atleast_1d(num)
    if num.ndim > 1:
        if num.shape[0] != 1:
            raise ValueError("frequency response requires a single-"
                             "output system (num has "
                             f"{num.shape[0]} rows)")
        num = num[0]
    return num


def _tuple_to_tf(system):
    n = len(system)
    if n == 2:
        return system
    if n == 3:
        return _design.zpk2tf(*system)
    if n == 4:
        return ss2tf(*system)
    raise ValueError("system must be a 2/3/4-tuple or lti instance")


def bode(system, w=None, n: int = 100):
    """Continuous Bode magnitude (dB) and phase (degrees)
    (scipy.signal.bode-compatible)."""
    w, h = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w, mag, phase


def dfreqresp(system, w=None, whole: bool = False, n: int = 10000):
    """Discrete frequency response H(e^{jw})
    (scipy.signal.dfreqresp-compatible; w in rad/sample)."""
    if _is_lti(system):
        if system.dt is None:
            raise ValueError("dfreqresp needs a discrete-time system")
        num, den = system._as_tf()
        dt = 1.0 if system.dt is True else float(system.dt)
    else:
        *sys_, dt = system
        dt = 1.0 if dt is True else float(dt)
        num, den = _tuple_to_tf(tuple(sys_))
    num = _single_output_num(num)
    if w is not None:
        w = np.asarray(w, np.float64)
        wz, h = _design.freqz(num, den, worN=w)
    else:
        wz, h = _design.freqz(num, den, worN=int(n), whole=whole)
    return wz, h


def dbode(system, w=None, n: int = 100):
    """Discrete Bode magnitude (dB) and phase (degrees)
    (scipy.signal.dbode-compatible: the returned frequencies are
    rad/time-unit, i.e. the rad/sample grid divided by dt)."""
    if _is_lti(system):
        dt = 1.0 if system.dt is True or system.dt is None \
            else float(system.dt)
    else:
        dt = system[-1]
        dt = 1.0 if dt is True else float(dt)
    w_, h = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w_ / dt, mag, phase


# ---------------------------------------------------------------------------
# Pole placement (scipy parity target: scipy/signal/_ltisys.py
# place_poles). SISO uses Ackermann's closed form (the gain is unique);
# MIMO uses KNV0-style det-maximizing iterations over the per-pole
# allowable eigenvector subspaces, with conjugate pairing so the gain
# stays real. Gains for MIMO systems are NOT unique, so parity with
# scipy is at the contract level: eig(A - B K) hits the requested
# poles.


class _PlacedPoles:
    """Result bundle (scipy's Bunch contract): gain_matrix,
    computed_poles, requested_poles, X, rtol, nb_iter."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        return (f"PlacedPoles(gain_matrix={self.gain_matrix!r}, "
                f"computed_poles={self.computed_poles!r}, "
                f"nb_iter={self.nb_iter})")


def _order_complex_poles(poles: np.ndarray) -> np.ndarray:
    """Sort with reals first (ascending), then conjugate pairs — and
    validate that every complex pole has its conjugate present."""
    ordered = np.sort(poles[np.isreal(poles)])
    im = poles[np.imag(poles) > 0]
    for p in np.sort_complex(im):
        # EXACT conjugate required (scipy raises rather than silently
        # substituting a nearby conjugate for the user's pole)
        if not np.any(poles == np.conj(p)):
            raise ValueError("complex poles must come in conjugate "
                             "pairs")
        ordered = np.concatenate((ordered, [p, np.conj(p)]))
    if ordered.shape[0] != poles.shape[0]:
        raise ValueError("complex poles must come in conjugate pairs")
    return ordered


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30):
    """Closed-loop pole placement: find K with
    ``eig(A - B K) = poles`` (scipy.signal.place_poles-compatible
    result contract).

    SISO systems use Ackermann's formula — the unique exact gain.
    MIMO systems run KNV0-style alternating projections: each pole's
    eigenvector must lie in the nullspace of ``B_perp^T (A - p I)``;
    the iteration re-picks each eigenvector inside its subspace to
    maximize |det X| (eigenvector independence = gain conditioning),
    pairing conjugates so K is real. ``method`` accepts 'YT'/'KNV0'
    for API compatibility (both run the same projection iteration
    here)."""
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    if A.shape[0] != A.shape[1]:
        raise ValueError("A must be square")
    n = A.shape[0]
    if B.shape[0] != n:
        raise ValueError("A and B must have the same number of rows")
    m = B.shape[1]
    poles = np.atleast_1d(np.asarray(poles, np.complex128))
    if poles.shape[0] != n:
        raise ValueError("exactly one pole per state is required")
    if method not in ("YT", "KNV0"):
        raise ValueError(f"unknown method {method!r}")
    if maxiter < 1:
        raise ValueError("maxiter must be at least equal to 1")
    if rtol > 1.0:
        raise ValueError("rtol can not be greater than 1")
    rank_B = np.linalg.matrix_rank(B)
    if rank_B == 0:
        raise ValueError("B must not be the zero matrix")
    poles = _order_complex_poles(poles)
    vals, mult = np.unique(np.round(poles, 10), return_counts=True)
    if np.any(mult > rank_B):
        raise ValueError("at least one of the requested pole is "
                         "repeated more than rank(B) times")

    if m == 1 or rank_B == 1:
        # Ackermann: K = e_n^T C^-1 phi(A), with C the controllability
        # matrix and phi the desired characteristic polynomial
        v1 = None if m == 1 else np.linalg.svd(B)[2][0:1].T
        bcol = B[:, :1] if m == 1 else B @ v1
        C = np.hstack([np.linalg.matrix_power(A, k) @ bcol
                       for k in range(n)])
        if np.linalg.matrix_rank(C) < n:
            raise ValueError("the system is not controllable from a "
                             "single input; Ackermann needs full "
                             "controllability")
        phi_coef = np.real(np.poly(poles))       # highest first
        phiA = np.zeros_like(A)
        for c in phi_coef:
            phiA = phiA @ A + c * np.eye(n)
        en = np.zeros((1, n))
        en[0, -1] = 1.0
        krow = en @ np.linalg.solve(C, phiA)
        K = krow if m == 1 else v1 @ krow
        X = np.linalg.eig(A - B @ K)[1]
        computed = np.linalg.eigvals(A - B @ K)
        return _PlacedPoles(gain_matrix=np.real(K),
                            computed_poles=_order_complex_poles(
                                np.round(computed, 12)),
                            requested_poles=poles, X=X,
                            rtol=0, nb_iter=0)

    # MIMO KNV0: allowable subspace per pole = null(B_perp^T (A - pI))
    U, _, _ = np.linalg.svd(B, full_matrices=True)
    B_perp = U[:, rank_B:]                       # (n, n - rank_B)
    subspaces = []
    for p in poles:
        Mnull = B_perp.T @ (A - p * np.eye(n))
        _, sv, Vh = np.linalg.svd(Mnull)
        ker_dim = n - np.sum(sv > max(sv.max(), 1e-300) * n * 1e-13) \
            if sv.size else n
        S = Vh.conj().T[:, n - max(ker_dim, rank_B):]
        subspaces.append(S)
    # conjugate-pair bookkeeping: poles ordered reals-then-pairs
    X = np.empty((n, n), np.complex128)
    for j, S in enumerate(subspaces):
        X[:, j] = S[:, 0]
    det_prev = 0.0
    nb_iter = 0
    cur_rtol = np.inf
    converged = False
    for it in range(maxiter):
        nb_iter = it
        skip = np.zeros(n, bool)
        for j in range(n):
            if skip[j]:
                continue
            others = np.delete(X, j, axis=1)
            Q, _ = np.linalg.qr(others, mode="complete")
            q = Q[:, -1]                         # orthogonal to others
            S = subspaces[j]
            proj = S @ (S.conj().T @ q)
            nrm = np.linalg.norm(proj)
            if nrm > 1e-12:
                X[:, j] = proj / nrm
            if np.imag(poles[j]) > 0 and j + 1 < n:
                X[:, j + 1] = np.conj(X[:, j])
                skip[j + 1] = True
        det_cur = abs(np.linalg.det(X))
        if det_prev > 0:
            cur_rtol = abs(det_cur - det_prev) / det_cur
            if cur_rtol < rtol:
                converged = True
                break
        det_prev = det_cur
    if not converged:
        warnings.warn("Convergence was not reached after maxiter "
                      "iterations. You should call place_poles with a "
                      "higher maxiter or looser rtol.", UserWarning,
                      stacklevel=2)
    Lam = np.diag(poles)
    M = np.linalg.lstsq(B, A @ X - X @ Lam, rcond=None)[0]
    K = np.real(M @ np.linalg.inv(X))
    computed = np.linalg.eigvals(A - B @ K)
    return _PlacedPoles(gain_matrix=K,
                        computed_poles=_order_complex_poles(
                            np.round(computed, 12)),
                        requested_poles=poles, X=X,
                        rtol=(0 if np.isinf(cur_rtol) else cur_rtol),
                        nb_iter=nb_iter)
