"""Chirp-z transform and zoom FFT (counterpart of ``tpufft/czt.py``;
scipy.signal.czt / zoom_fft semantics).

The CZT of length-n input at the m spiral points ``z_k = a * w**-k`` is a
chirp-premultiplied circular convolution (Bluestein's identity
``w**(jk) = w**(j^2/2) w**(k^2/2) / w**((k-j)^2/2)``), evaluated as
FFT_L -> pointwise -> IFFT_L at an aligned fast length ``L >= n + m - 1``.
The forward transform zero-pads inside K9's load when
``execute.pad_axis_ok`` says it fits (``execute.fft_axis_padded``), the
inverse runs ``execute.fft_axis`` (K1 on the minor axis); no kernel of
its own. The chirp tables are float64 host precomputes (exact integer
reduction of the default-w angles), cast to the planes' dtype and
uploaded once per device.

Input and output forms follow the port's API: ``SplitComplex`` planes
give ``SplitComplex``, a tensor gives a complex tensor on its device
(complex128 for float64 tensors, which run the same pipeline in f64),
numpy float32/complex64 gives numpy complex64, computed on ``device``
(the CUDA device unless the caller names another), and numpy
float64/complex128 runs tpufft's exact host f64 pipeline. CUDA has complex
tensors, so tpufft's branch that returns ``SplitComplex`` from a
complex-free backend has no counterpart here. Differentiable: every step
is a torch op or a differentiable transform.
"""

from __future__ import annotations

import cmath
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import execute as _execute
from .api import numpy_device
from .config import PlanConfig
from .core import SplitComplex
from .planner import default_bases, next_fast_len

__all__ = ["CZT", "ZoomFFT", "czt", "zoom_fft", "czt_points"]


def _validate_sizes(n: int, m: int | None) -> int:
    n = int(n)
    if n < 1:
        raise ValueError(f"Invalid number of CZT data points ({n}) specified")
    m = n if m is None else int(m)
    if m < 1:
        raise ValueError(f"Invalid number of CZT output points ({m}) "
                         "specified")
    return m


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j):
    """The points on the z-plane a CZT samples: ``z_k = a * w**-k``
    (scipy.signal.czt_points-compatible). Default ``w`` walks the full
    unit circle (the FFT points), computed with exact angles."""
    m = _validate_sizes(1, m)
    k = np.arange(m)
    a = complex(a)
    if w is None:
        return a * np.exp(2j * np.pi * k / m)
    return a * complex(w) ** -k.astype(np.float64)


class CZT:
    """Plan for repeated chirp-z transforms (scipy.signal.CZT-compatible
    callable): length-``n`` input -> the z-transform at ``m`` spiral points
    ``a * w**-k``. ``device``: where numpy input runs (None: the CUDA
    device)."""

    def __init__(self, n: int, m: int | None = None,
                 w: complex | None = None, a: complex = 1 + 0j, *,
                 config: PlanConfig | None = None, device=None):
        m = _validate_sizes(n, m)
        k = np.arange(max(m, n), dtype=np.int64)
        if w is None:
            # default = FFT spiral: exact integer reduction of the angle
            # (pi * (k^2 mod 2m) / m == pi * k^2 / m mod 2 pi for any k)
            w = cmath.exp(-2j * np.pi / m)
            wk2 = np.exp(-1j * np.pi * ((k * k) % (2 * m)) / m)
        else:
            w = complex(w)
            if w == 0:
                raise ValueError("w must be nonzero")
            wk2 = w ** (k * k / 2.0)
        self._finish_init(int(n), m, w, complex(a), wk2, config, device)

    def _finish_init(self, n: int, m: int, w: complex, a: complex,
                     wk2: np.ndarray, config: PlanConfig | None, device):
        """Shared tail of CZT/ZoomFFT construction; ``wk2[k] = w**(k^2/2)``
        comes from the class's own (precision-preserving) formula."""
        self.n, self.m, self.w, self.a = n, m, w, a
        self.config = config or PlanConfig()
        self.device = device
        self._L = next_fast_len(n + m - 1, aligned=True)
        # Awk2[j] = a^-j w^(j^2/2): the input chirp and the spiral start in
        # one premultiply
        self._Awk2 = a ** -np.arange(n, dtype=np.float64) * wk2[:n]
        # FFT_L of the inverse chirp, arranged so that the linear
        # convolution's valid window is indices [n-1, n+m-1)
        inv = 1.0 / wk2
        self._Fwk2 = np.fft.fft(np.concatenate([inv[n - 1:0:-1], inv[:m]]),
                                self._L)
        self._wk2_out = wk2[:m]
        self._device_tables = {}

    def points(self):
        """The z-plane points this plan evaluates (czt_points of this
        plan's parameters)."""
        k = np.arange(self.m)
        return complex(self.a) * complex(self.w) ** -k.astype(np.float64)

    # -- the device path (split planes) --------------------------------------

    def _tables(self, device, dtype):
        """(Ar, Ai, Br, Bi, Pr, Pi) on ``device`` in ``dtype``, uploaded
        once."""
        key = (torch.device(device), dtype)
        tables = self._device_tables.get(key)
        if tables is None:
            tables = tuple(
                torch.as_tensor(np.ascontiguousarray(p), dtype=dtype,
                                device=key[0])
                for t in (self._Awk2, self._Fwk2, self._wk2_out)
                for p in (t.real, t.imag))
            self._device_tables[key] = tables
        return tables

    def _apply_planes(self, re, im, axis: int):
        """The CZT of re/im planes (``im`` None: a real input) along
        ``axis``: f32 planes (bf16 widened), f64 planes stay f64."""
        n, m, L = self.n, self.m, self._L
        ax = axis % re.ndim
        if re.shape[ax] != n:
            raise ValueError(f"CZT input length {n} != axis length "
                             f"{re.shape[ax]}")
        dt = torch.float64 if re.dtype == torch.float64 else torch.float32
        re = re.movedim(ax, -1)
        lead = re.shape[:-1]
        re = re.reshape(-1, n).to(dt)
        Ar, Ai, Br, Bi, Pr, Pi = self._tables(re.device, dt)
        if im is None:
            pr, pi = re * Ar, re * Ai
        else:
            im = im.movedim(ax, -1).reshape(-1, n).to(dt)
            pr, pi = re * Ar - im * Ai, re * Ai + im * Ar
        cfg = self.config
        bases = default_bases(L, cfg.max_radix)
        if L > n and _execute.pad_axis_ok(n, L, dt, cfg):
            # K9: the zero-pad to L happens inside the transform's load
            pr, pi = _execute.fft_axis_padded(pr, pi, 1, L, inverse=False,
                                              scale=1.0, config=cfg)
        else:
            pad = (0, L - n)
            pr, pi = _execute.fft_axis(F.pad(pr, pad), F.pad(pi, pad), 1,
                                       bases, inverse=False, scale=1.0,
                                       config=cfg)
        pr, pi = pr * Br - pi * Bi, pr * Bi + pi * Br
        pr, pi = _execute.fft_axis(pr, pi, 1, bases, inverse=True,
                                   scale=1.0 / L, config=cfg)
        pr, pi = pr[:, n - 1:n + m - 1], pi[:, n - 1:n + m - 1]
        outr = (pr * Pr - pi * Pi).reshape(lead + (m,)).movedim(-1, ax)
        outi = (pr * Pi + pi * Pr).reshape(lead + (m,)).movedim(-1, ax)
        return outr, outi

    # -- the host f64 tier ----------------------------------------------------

    def _f64_pipeline(self, xn: np.ndarray, axis: int) -> np.ndarray:
        """Exact host complex128 evaluation (tpufft's f64 tier)."""
        n, m, L = self.n, self.m, self._L
        x = np.moveaxis(np.asarray(xn, np.complex128), axis, -1)
        y = np.fft.ifft(np.fft.fft(x * self._Awk2, L) * self._Fwk2)
        y = y[..., n - 1:n + m - 1] * self._wk2_out
        return np.moveaxis(y, -1, axis)

    def __call__(self, x, *, axis: int = -1):
        shape = _shape(x)
        ax = axis % len(shape)
        if shape[ax] != self.n:
            raise ValueError(f"CZT input length {self.n} != axis length "
                             f"{shape[ax]}")
        if isinstance(x, SplitComplex):
            return SplitComplex(*self._apply_planes(x.re, x.im, ax))
        is_np = not isinstance(x, torch.Tensor)
        if is_np:
            xn = np.asarray(x)
            if xn.dtype in (np.float64, np.complex128):
                return self._f64_pipeline(xn, ax)
            x = torch.from_numpy(np.ascontiguousarray(xn)).to(
                numpy_device(self.device))
        if x.is_complex():
            out = torch.complex(*self._apply_planes(x.real, x.imag, ax))
        else:
            out = torch.complex(*self._apply_planes(x, None, ax))
        return out.detach().cpu().numpy() if is_np else out


class ZoomFFT(CZT):
    """Plan for repeated zoomed FFTs (scipy.signal.ZoomFFT-compatible):
    the DFT over the band ``fn = [f1, f2]`` (or ``[0, fn]`` for a scalar)
    of a signal sampled at ``fs``, with ``m`` output bins. A CZT on the
    unit-circle arc; the chirp angles come from the exact band formula
    (not ``w**(k^2/2)``), so precision holds for large ``k``, as in
    scipy."""

    def __init__(self, n: int, fn, m: int | None = None, *, fs: float = 2,
                 endpoint: bool = False, config: PlanConfig | None = None,
                 device=None):
        m = _validate_sizes(n, m)
        k = np.arange(max(m, n), dtype=np.int64)
        fn_arr = np.asarray(fn, np.float64)
        if fn_arr.size == 2:
            f1, f2 = (float(v) for v in fn_arr.reshape(2))
        elif fn_arr.size == 1:
            f1, f2 = 0.0, float(fn_arr.reshape(()))
        else:
            raise ValueError("fn must be a scalar or 2-length sequence")
        self.f1, self.f2, self.fs = f1, f2, float(fs)
        if endpoint:
            scale = ((f2 - f1) * m) / (self.fs * (m - 1))
        else:
            scale = (f2 - f1) / self.fs
        a = cmath.exp(2j * np.pi * f1 / self.fs)
        wk2 = np.exp(-1j * np.pi * scale * (k * k).astype(np.float64) / m)
        w = cmath.exp(-2j * np.pi / m * scale)
        self._finish_init(int(n), m, w, a, wk2, config, device)


@functools.lru_cache(maxsize=64)
def _czt_plan(n: int, m: int | None, w: complex | None, a: complex,
              config: PlanConfig | None, device) -> CZT:
    return CZT(n, m=m, w=w, a=a, config=config, device=device)


@functools.lru_cache(maxsize=64)
def _zoom_plan(n: int, fn: tuple, m: int | None, fs: float, endpoint: bool,
               config: PlanConfig | None, device) -> ZoomFFT:
    return ZoomFFT(n, fn, m=m, fs=fs, endpoint=endpoint, config=config,
                   device=device)


def _shape(x) -> tuple:
    if isinstance(x, (SplitComplex, torch.Tensor)):
        return tuple(x.shape)
    return np.shape(x)


def czt(x, m: int | None = None, w: complex | None = None,
        a: complex = 1 + 0j, *, axis: int = -1,
        config: PlanConfig | None = None, device=None):
    """Chirp-z transform (scipy.signal.czt-compatible): the z-transform of
    ``x`` along ``axis`` at ``m`` points ``a * w**-k``. ``w=None`` walks
    the unit circle (``m=n`` reproduces ``fft``)."""
    plan = _czt_plan(int(_shape(x)[axis]), None if m is None else int(m),
                     None if w is None else complex(w), complex(a), config,
                     None if device is None else str(torch.device(device)))
    return plan(x, axis=axis)


def zoom_fft(x, fn, m: int | None = None, *, fs: float = 2,
             endpoint: bool = False, axis: int = -1,
             config: PlanConfig | None = None, device=None):
    """Zoomed FFT (scipy.signal.zoom_fft-compatible): the DFT of ``x``
    sampled at ``fs``, evaluated only over the band ``fn``."""
    fn_key = tuple(np.asarray(fn, np.float64).reshape(-1).tolist())
    plan = _zoom_plan(int(_shape(x)[axis]), fn_key,
                      None if m is None else int(m), float(fs),
                      bool(endpoint), config,
                      None if device is None else str(torch.device(device)))
    return plan(x, axis=axis)
