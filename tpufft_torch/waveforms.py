"""Waveform generators (counterpart of ``tpufft/waveforms.py``;
scipy.signal semantics): chirps, pulses and test sequences.

The samplers (``sawtooth``, ``square``, ``chirp``, ``sweep_poly``,
``gausspulse``) take tpufft's input contract: a torch tensor time grid
computes in torch ops where it lies and its result stays a tensor there
(float32 stays float32, float64 stays float64, other dtypes compute in
float32), and numpy input stays on the host in float64. Each is one
elementwise pass over the grid; there is no kernel of its own. Phase
polynomials are integrated exactly on the host (``np.polyint``). In
float32 a phase of size |phase| radians is only known to about
|phase| * 6e-8, which bounds how closely a long sweep can agree with a
float64 reference.

``chirp(complex=True)`` returns exp(1j (phase + phi)) as scipy does: a
complex tensor for tensor input. ``unit_impulse`` follows scipy's rule for
a scalar ``idx`` on an N-D shape (the impulse at (idx,) * ndim), and
``unit_impulse`` and ``max_len_seq`` (a sequential LFSR) return host numpy:
their output is test data, not device compute.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["chirp", "sweep_poly", "gausspulse", "square", "sawtooth",
           "unit_impulse", "max_len_seq"]

_FLOATS = (torch.float32, torch.float64)


def _grid(t):
    """``t`` as the array the samplers compute on, and its module: a tensor
    keeps its device (and float32/float64 dtype), numpy becomes float64."""
    if isinstance(t, torch.Tensor):
        return (t if t.dtype in _FLOATS else t.to(torch.float32)), torch
    return np.asarray(t, np.float64), np


def _param(v, like, xp):
    """A scalar or array-valued parameter on ``like``'s device and dtype."""
    if xp is np:
        return np.asarray(v)
    return torch.as_tensor(np.asarray(v, np.float64), dtype=like.dtype,
                           device=like.device)


def sawtooth(t, width=1.0):
    """Periodic sawtooth/triangle wave with period 2*pi
    (scipy.signal.sawtooth-compatible): rises 0 -> width of each period,
    falls width -> 1; width=1 is the classic sawtooth, width=0.5 a
    triangle. Out-of-range width yields NaN like scipy."""
    t, xp = _grid(t)
    w = _param(width, t, xp)
    tmod = xp.remainder(t, 2 * math.pi)
    # broadcast-safe branches (array-valued width broadcasts per sample,
    # like scipy); guard the w == 0 / w == 1 divisions
    one = _param(1.0, t, xp)
    w_safe = xp.where(w > 0, w, one)
    rising = tmod / (math.pi * w_safe) - 1.0
    wm1 = xp.where(w < 1, 1.0 - w, one)
    falling = (math.pi * (w + 1) - tmod) / (math.pi * wm1)
    out = xp.where(tmod < w * 2 * math.pi, rising, falling)
    bad = (w < 0) | (w > 1)
    return xp.where(bad, _param(math.nan, t, xp), out)


def square(t, duty=0.5):
    """Periodic square wave with period 2*pi
    (scipy.signal.square-compatible): +1 for the first ``duty`` fraction
    of each period, -1 for the rest."""
    t, xp = _grid(t)
    d = _param(duty, t, xp)
    tmod = xp.remainder(t, 2 * math.pi)
    out = xp.where(tmod < d * 2 * math.pi, _param(1.0, t, xp),
                   _param(-1.0, t, xp))
    bad = (d < 0) | (d > 1)
    return xp.where(bad, _param(math.nan, t, xp), out)


def _chirp_phase(t, f0: float, t1: float, f1: float, method: str,
                 vertex_zero: bool, xp):
    """Integrated instantaneous frequency, in cycles (not radians)."""
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        return f0 * t + 0.5 * beta * t * t
    if method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 ** 2)
        if vertex_zero:
            return f0 * t + beta * t ** 3 / 3.0
        return f1 * t + beta * ((t1 - t) ** 3 - t1 ** 3) / 3.0
    if method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0:
            raise ValueError("logarithmic chirp needs f0 and f1 nonzero "
                             "with the same sign")
        if f0 == f1:
            return f0 * t
        ratio = f1 / f0
        return f0 * t1 / math.log(ratio) * (ratio ** (t / t1) - 1.0)
    if method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic chirp needs nonzero f0 and f1")
        if f0 == f1:
            return f0 * t
        sing = -f1 * t1 / (f0 - f1)   # the 1/f singularity location
        return -sing * f0 * xp.log(xp.abs(1.0 - t / sing))
    raise ValueError(f"unknown chirp method {method!r}")


def chirp(t, f0, t1, f1, method="linear", phi=0, vertex_zero=True, *,
          complex=False):
    """Frequency-swept cosine (scipy.signal.chirp-compatible):
    linear / quadratic / logarithmic / hyperbolic sweeps from f0 at t=0
    to f1 at t=t1; ``complex=True`` returns the analytic exp(j*...)
    form like modern scipy."""
    t, xp = _grid(t)
    phase = 2 * math.pi * _chirp_phase(t, float(f0), float(t1), float(f1),
                                       method, vertex_zero, xp)
    phi_r = float(phi) * math.pi / 180.0
    if complex:
        if xp is np:
            return np.exp(1j * (phase + phi_r))
        return torch.polar(torch.ones_like(phase), phase + phi_r)
    return xp.cos(phase + phi_r)


def sweep_poly(t, poly, phi=0):
    """Cosine with polynomial instantaneous frequency
    (scipy.signal.sweep_poly-compatible): ``poly`` gives f(t) (highest
    power first or np.poly1d); the phase is its exact antiderivative."""
    coefs = np.asarray(np.poly1d(poly).coefficients, np.float64)
    intp = np.polyint(coefs)
    t, xp = _grid(t)
    if xp is np:
        phase = np.polyval(intp, t)
    else:
        phase = torch.zeros_like(t)
        for c in intp:
            phase = phase * t + float(c)
    return xp.cos(2 * math.pi * phase + float(phi) * math.pi / 180.0)


def gausspulse(t, fc=1000, bw=0.5, bwr=-6, tpr=-60, retquad=False,
               retenv=False):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse-compatible).

    ``t='cutoff'`` returns the time where the envelope falls to ``tpr``
    dB. Otherwise returns yI (in-phase), optionally yQ (quadrature)
    and/or yenv, in scipy's order."""
    fc, bw, bwr, tpr = float(fc), float(bw), float(bwr), float(tpr)
    if fc < 0:
        raise ValueError("fc must be >= 0")
    if bw <= 0:
        raise ValueError("bw must be > 0")
    if bwr >= 0:
        raise ValueError("bwr must be < 0 dB")
    ref = 10.0 ** (bwr / 20.0)
    # envelope exp(-a t^2) whose spectrum is ref at fc*bw/2 off-center
    a = -(math.pi * fc * bw) ** 2 / (4.0 * math.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError("t must be an array or the string 'cutoff'")
        if tpr >= 0:
            raise ValueError("tpr must be < 0 dB")
        eref = 10.0 ** (tpr / 20.0)
        return math.sqrt(-math.log(eref) / a)
    t, xp = _grid(t)
    yenv = xp.exp(-a * t * t)
    yI = yenv * xp.cos(2 * math.pi * fc * t)
    out = [yI]
    if retquad:
        out.append(yenv * xp.sin(2 * math.pi * fc * t))
    if retenv:
        out.append(yenv)
    return out[0] if len(out) == 1 else tuple(out)


def unit_impulse(shape, idx=None, dtype=float):
    """Unit impulse delta[n - idx] (scipy.signal.unit_impulse-compatible;
    ``idx='mid'`` centers it, a scalar idx on an N-D shape places it at
    (idx,) * ndim)."""
    out = np.zeros(shape, dtype)
    if idx is None:
        idx = (0,) * out.ndim
    elif isinstance(idx, str):
        if idx != "mid":
            raise ValueError(f"idx must be None, 'mid' or indices, got "
                             f"{idx!r}")
        idx = tuple(s // 2 for s in out.shape)
    elif not hasattr(idx, "__iter__"):
        idx = (int(idx),) * out.ndim
    out[tuple(idx)] = 1
    return out


# Primitive-polynomial feedback taps for maximal-length LFSRs, one known
# primitive polynomial per register size (published tables, e.g.
# Zierler/Peterson; the same standard choices scipy documents).
_MLS_TAPS = {
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
    9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
    14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14],
    18: [11], 19: [18, 17, 14], 20: [17], 21: [19], 22: [21],
    23: [18], 24: [23, 22, 17], 25: [22], 26: [25, 24, 20],
    27: [26, 25, 22], 28: [25], 29: [27], 30: [29, 28, 7],
    31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits: int, state=None, length=None, taps=None):
    """Maximal-length (pseudo-random) binary sequence from an LFSR
    (scipy.signal.max_len_seq-compatible): period 2**nbits - 1; returns
    (seq, final_state) so calls can be chained."""
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError("nbits must be between 2 and 32 when taps "
                             "is not given")
        taps = _MLS_TAPS[nbits]
    taps = np.unique(np.asarray(taps, np.intp))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits) or taps.size == 0:
        raise ValueError("taps must be integers in [0, nbits]")
    n_max = (1 << nbits) - 1
    if length is None:
        length = n_max
    length = int(length)
    if length < 0:
        raise ValueError("length must be >= 0")
    if state is None:
        state = np.ones(nbits, np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
        if state.ndim != 1 or state.shape[0] != nbits:
            raise ValueError("state must be a 1-D array of length nbits")
        if not np.any(state):
            raise ValueError("state must not be all zeros")
    state = state.copy()
    seq = np.empty(length, np.int8)
    # Galois-style circular-buffer LFSR (no shifting: the register is a
    # ring and idx walks it): output = state[idx]; the tapped cells XOR
    # into that slot; the final state is reported in canonical order
    # (rolled so idx is first) — bit-exact with scipy's recurrence
    idx = 0
    for i in range(length):
        fb = state[idx]
        seq[i] = fb
        for t in taps:
            fb ^= state[(t + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx)
