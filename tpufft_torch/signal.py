"""Spectral filtering and FFT convolution (counterpart of
``tpufft/signal.py``; scipy.signal semantics).

A circular filter ``y = ifft(fft(x) * H)`` along one axis is a linear map:
the circulant matrix ``C[j, m] = c[(m - j) mod n]`` of the impulse
response ``c = ifft(H)``. ``FilterPlan`` keeps tpufft's two routes:

* 2 <= n <= ``FILTER_DENSE_MAX_N``: ``y = x @ C`` in one pass of the dense
  kernel (``kernels/dense_mm``): K10 for complex planes, K11 when the
  impulse is real and the input is real (a real circulant, one real
  product). ``backend="xla"`` runs the same products as ``torch.matmul``.
* longer axes: ``fft_axis`` -> pointwise H -> ``fft_axis`` on the FFT
  kernels; the n x n circulant is never built.

``FILTER_DENSE_MAX_N`` is tpufft's TPU crossover, kept as it is; the H100
crossover is measured in PERF.md.

Input and output forms follow the port's API (``api.py``): a tensor in
gives a tensor out on its device (complex where tpufft returns complex),
``SplitComplex`` in gives ``SplitComplex`` out, numpy in gives numpy out,
computed on ``device`` (the CUDA device unless the caller names another).
CUDA has complex tensors, so tpufft's branches that return
``SplitComplex`` from a complex-free backend have no counterpart here.
float64 input takes tpufft's f64 tier: the host ``np.fft`` pipeline for
numpy, the port's f64 transforms where an f64 tensor lies. The filter is
differentiable: the dense path's backward is ``g @ C^H`` (``g @ C^T`` on
the real path), the same kernels with the adjoint table; the composed
path's is that of its transforms.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from . import api
from . import execute as _execute
from .api import numpy_device
from .config import PlanConfig
from .core import SplitComplex
from .kernels import dense_mm
from .planner import default_bases, next_fast_len

__all__ = ["plan_filter", "FilterPlan", "fftconvolve", "oaconvolve",
           "hilbert", "hilbert2", "resample", "correlate", "envelope"]

# Largest axis run as a dense circulant product (tpufft's TPU crossover);
# beyond it the plan composes fft -> multiply -> ifft.
FILTER_DENSE_MAX_N = 512


def _is_host_f64(x) -> bool:
    """numpy input of tpufft's f64 tier (float64 or complex128)."""
    return np.asarray(x).dtype in (np.float64, np.complex128)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _operands(in1, in2, device):
    """Both inputs as tensors on one device: numpy on the other's device
    when one is a tensor, else on ``device`` (``api.numpy_device``)."""
    if isinstance(in1, torch.Tensor):
        dev = in1.device
    elif isinstance(in2, torch.Tensor):
        dev = in2.device
    else:
        dev = numpy_device(device)

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return tensor(in1), tensor(in2)


# ----------------------------------------------------------------------------
# Circular filter
# ----------------------------------------------------------------------------

def _circulant(c: np.ndarray) -> np.ndarray:
    """C[j, m] = c[(m - j) mod n] so that (x @ C) is circular convolution
    of x with c."""
    n = c.shape[0]
    idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
    return c[idx]


class _DenseComplex(torch.autograd.Function):
    """(xr + i xi) @ C on K10; the backward is g @ C^H, K10 with the
    adjoint table (tpufft's transposed-matrix VJP)."""

    @staticmethod
    def forward(ctx, xr, xi, plan):
        ctx.plan = plan
        return plan._dense_complex(xr, xi, adjoint=False)

    @staticmethod
    def backward(ctx, gr, gi):
        br, bi = ctx.plan._dense_complex(gr.contiguous(), gi.contiguous(),
                                         adjoint=True)
        return br, bi, None


class _DenseReal(torch.autograd.Function):
    """x @ Cr on K11 for a real circulant; the backward is g @ Cr^T."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan._dense_real(x, adjoint=False)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan._dense_real(g.contiguous(), adjoint=True), None


class FilterPlan:
    """One-axis circular filter, callable like a transform plan.

    Accepts complex or real tensors, ``SplitComplex`` planes or numpy
    arrays and returns the matching form; a real impulse on real input
    returns a real result. ``device`` is where numpy input runs (None: the
    CUDA device). Differentiable.
    """

    def __init__(self, n: int, c_time: np.ndarray, axis: int,
                 config: PlanConfig, device=None):
        self.n = int(n)
        self.axis = int(axis)
        self.config = config
        self.device = device
        c = np.asarray(c_time, np.complex128)
        self._c = c
        H = np.fft.fft(c)
        self._hr = np.ascontiguousarray(H.real, np.float64)
        self._hi = np.ascontiguousarray(H.imag, np.float64)
        self._real_matrix = bool(np.max(np.abs(c.imag)) < 1e-12 * max(
            1.0, float(np.max(np.abs(c)))))
        # the device tables are shared by every plan of the same impulse
        self._key = ("filter", self.n, hashlib.sha1(c.tobytes()).hexdigest())
        # The O(n^2) circulant exists only on the dense path: a long-axis
        # plan (e.g. hilbert over a 100k-sample signal) must not build, or
        # hold, an n x n float64 matrix it never uses.
        self._cr = self._ci = None
        if self._use_dense():
            C = _circulant(c)
            self._cr = np.ascontiguousarray(C.real, np.float64)
            self._ci = np.ascontiguousarray(C.imag, np.float64)

    def _use_dense(self) -> bool:
        return 2 <= self.n <= FILTER_DENSE_MAX_N

    # -- the dense path (K10, K11) --------------------------------------------

    def _table(self, name: str, device, dtype=torch.float32):
        """A table of this plan on ``device``, uploaded once: "cr"/"ci" the
        circulant's planes, "cr_t"/"-ci_t" the adjoint's, "block"/"block_t"
        their block tables (K10's tensor-core operand), "hr"/"hi" the
        response."""
        build = {"cr": lambda: self._cr, "ci": lambda: self._ci,
                 "cr_t": lambda: self._cr.T, "-ci_t": lambda: -self._ci.T,
                 "block": lambda: dense_mm.block_table(self._cr, self._ci),
                 "block_t": lambda: dense_mm.block_table(self._cr.T,
                                                         -self._ci.T),
                 "hr": lambda: self._hr, "hi": lambda: self._hi}[name]
        return dense_mm.device_table(self._key + (name,), build, device,
                                     dtype)

    def _dense_complex(self, xr, xi, adjoint: bool):
        dev, dt = xr.device, xr.dtype
        wr = self._table("cr_t" if adjoint else "cr", dev, dt)
        wi = self._table("-ci_t" if adjoint else "ci", dev, dt)
        if self.config.backend == "xla":
            return xr @ wr - xi @ wi, xr @ wi + xi @ wr
        wb = None
        if xr.is_cuda and dense_mm.form(*wr.shape) == "tf32x3":
            wb = self._table("block_t" if adjoint else "block", dev, dt)
        return dense_mm.dense_mm_complex(xr, xi, wr, wi, wb)

    def _dense_real(self, x, adjoint: bool):
        w = self._table("cr_t" if adjoint else "cr", x.device, x.dtype)
        if self.config.backend == "xla":
            return x @ w
        return dense_mm.dense_mm_real(x, w)

    # -- the composed path (fft -> H -> ifft) ---------------------------------

    def _composed(self, xr, xi):
        bases = default_bases(self.n, self.config.max_radix)
        hr = self._table("hr", xr.device, xr.dtype)
        hi = self._table("hi", xr.device, xr.dtype)
        cfg = self.config
        Xr, Xi = _execute.fft_axis(xr, xi, 1, bases, inverse=False,
                                   scale=1.0, config=cfg)
        Yr = Xr * hr - Xi * hi
        Yi = Xr * hi + Xi * hr
        return _execute.fft_axis(Yr, Yi, 1, bases, inverse=True,
                                 scale=1.0 / self.n, config=cfg)

    # -- application ----------------------------------------------------------

    def _check_length(self, shape) -> None:
        got = shape[self.axis % len(shape)]
        if got != self.n:
            raise ValueError(f"filter length {self.n} != axis length {got}")

    def _rows(self, t: torch.Tensor, dtype) -> torch.Tensor:
        """t with the filtered axis minor, as (rows, n) of ``dtype``."""
        t = t.movedim(self.axis % t.ndim, -1)
        return t.reshape(-1, self.n).to(dtype).contiguous()

    def _back(self, y: torch.Tensor, shape) -> torch.Tensor:
        axis = self.axis % len(shape)
        moved = list(shape)
        moved.append(moved.pop(axis))
        return y.reshape(moved).movedim(-1, axis)

    def _apply_planes(self, re, im):
        """The filter on re/im planes: f32 (f64 planes stay f64, on the
        composed path)."""
        self._check_length(tuple(re.shape))
        f64 = re.dtype == torch.float64
        dt = torch.float64 if f64 else torch.float32
        xr = self._rows(re, dt)
        xi = None if im is None else self._rows(im, dt)
        if not f64 and self._use_dense():
            if xi is None:
                xi = torch.zeros_like(xr)
            yr, yi = _DenseComplex.apply(xr, xi, self)
        else:
            yr, yi = self._composed(xr, xi)
        return self._back(yr, re.shape), self._back(yi, re.shape)

    def _apply_real(self, x):
        """The real-circulant filter on real input: one real product (K11)
        on the dense path, the real plane of the composed path else."""
        self._check_length(tuple(x.shape))
        if x.dtype != torch.float64 and self._use_dense():
            return self._back(_DenseReal.apply(self._rows(x, torch.float32),
                                               self), x.shape)
        return self._apply_planes(x, None)[0]

    def _f64_pipeline(self, xn: np.ndarray) -> np.ndarray:
        """The f64 tier for float64/complex128 numpy input: host numpy
        fft * H * ifft, exact for any n, no O(n^2) matrix."""
        Hc = self._hr + 1j * self._hi
        shape = [1] * xn.ndim
        shape[self.axis % xn.ndim] = self.n
        return np.fft.ifft(np.fft.fft(xn, axis=self.axis) * Hc.reshape(shape),
                           axis=self.axis)

    def __call__(self, x):
        if isinstance(x, SplitComplex):
            return SplitComplex(*self._apply_planes(x.re, x.im))
        is_np = not isinstance(x, torch.Tensor)
        if is_np:
            xn = np.asarray(x)
            self._check_length(xn.shape)
            if _is_host_f64(xn):
                y = self._f64_pipeline(xn)
                real_out = self._real_matrix and not np.iscomplexobj(xn)
                return np.real(y) if real_out else y
            x = torch.from_numpy(np.ascontiguousarray(xn)).to(
                numpy_device(self.device))
        if x.is_complex():
            out = torch.complex(*self._apply_planes(x.real, x.imag))
        elif self._real_matrix:
            y = self._apply_real(x)
            out = y.to(x.dtype if x.is_floating_point() else torch.float32)
        else:
            out = torch.complex(*self._apply_planes(x, None))
        return _to_numpy(out) if is_np else out


def plan_filter(n: int, response=None, *, impulse=None, axis: int = -1,
                config: PlanConfig | None = None, device=None) -> FilterPlan:
    """Plan a circular filter along one axis: y = ifft(fft(x, axis) * H).

    Exactly one of ``response`` (frequency response H, length n) or
    ``impulse`` (time-domain circular kernel c = ifft(H), length n) must be
    given. A Hermitian-symmetric response (real impulse) applied to a real
    array returns a real array. ``device``: where numpy input runs (None:
    the CUDA device).
    """
    if (response is None) == (impulse is None):
        raise ValueError("give exactly one of response= or impulse=")
    n = int(n)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if impulse is not None:
        c = np.asarray(impulse, np.complex128)
        if c.shape != (n,):
            raise ValueError(f"impulse must have shape ({n},)")
    else:
        H = np.asarray(response, np.complex128)
        if H.shape != (n,):
            raise ValueError(f"response must have shape ({n},)")
        c = np.fft.ifft(H)
    return FilterPlan(n, c, axis, config or PlanConfig(), device)


# ----------------------------------------------------------------------------
# fftconvolve (scipy.signal semantics)
# ----------------------------------------------------------------------------

def _conv_axes(s1, s2, axes):
    ndim = len(s1)
    if axes is None:
        axes = tuple(range(ndim))
    elif np.isscalar(axes):
        axes = (int(axes),)
    axes = tuple(sorted(a % ndim for a in axes))
    if not axes:
        raise ValueError("when provided, axes cannot be empty")
    if len(set(axes)) != len(axes):
        raise ValueError("duplicate axes")
    for a in range(ndim):
        if a not in axes and s1[a] != s2[a] and 1 not in (s1[a], s2[a]):
            raise ValueError(
                f"incompatible shapes on non-convolved axis {a}: "
                f"{s1[a]} vs {s2[a]}")
    return axes


def _centered(arr, newshape):
    slices = []
    for cur, new in zip(arr.shape, newshape):
        start = (cur - new) // 2
        slices.append(slice(start, start + new))
    return arr[tuple(slices)]


def _real_result(out: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """A real convolution's result in the inputs' promoted float dtype
    (kept as computed when that is not a float)."""
    want = torch.promote_types(a.dtype, b.dtype)
    if out.dtype != want and want.is_floating_point:
        out = out.to(want)
    return out


def fftconvolve(in1, in2, mode: str = "full", axes=None, *,
                config: PlanConfig | None = None, device=None):
    """N-D convolution via FFT (scipy.signal.fftconvolve-compatible: modes
    "full"/"same"/"valid", axes subsets, broadcasting on non-convolved
    axes). Real inputs run rfftn/irfftn; lengths pad to ``next_fast_len``."""
    is_np = not (isinstance(in1, torch.Tensor)
                 or isinstance(in2, torch.Tensor))
    a, b = _operands(in1, in2, device)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if a.ndim == 0:
        out = a * b
        return _to_numpy(out) if is_np else out
    if a.numel() == 0 or b.numel() == 0:
        # scipy returns an empty array, not a 0-d scalar
        out = a.new_zeros((0,), dtype=torch.promote_types(a.dtype, b.dtype))
        return _to_numpy(out) if is_np else out
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    axes = _conv_axes(a.shape, b.shape, axes)
    s1, s2 = tuple(a.shape), tuple(b.shape)
    if mode == "valid":
        ok1 = all(s1[ax] >= s2[ax] for ax in axes)
        ok2 = all(s2[ax] >= s1[ax] for ax in axes)
        if not (ok1 or ok2):
            raise ValueError(
                "for mode='valid' one input must be at least as large as "
                "the other in every convolved axis")
        if not ok1:
            a, b = b, a
            s1, s2 = s2, s1
    full = [s1[ax] + s2[ax] - 1 for ax in axes]
    fast = [next_fast_len(f) for f in full]
    real = not (a.is_complex() or b.is_complex())
    kw = dict(s=tuple(fast), axes=axes, config=config)
    if real:
        conv = api.irfftn(api.rfftn(a, **kw) * api.rfftn(b, **kw), **kw)
    else:
        conv = api.ifftn(api.fftn(a, **kw) * api.fftn(b, **kw), **kw)
    # crop the fast-length padding back to the full linear-conv shape
    sl = [slice(None)] * conv.ndim
    for ax, f in zip(axes, full):
        sl[ax] = slice(0, f)
    conv = conv[tuple(sl)]
    if mode == "full":
        out = conv
    elif mode == "same":
        # scipy crops to in1's shape on every axis, broadcast ones included
        out = _centered(conv, s1)
    else:  # valid: convolved axes crop to s1-s2+1, the others keep theirs
        shape = list(conv.shape)
        for ax in axes:
            shape[ax] = s1[ax] - s2[ax] + 1
        out = _centered(conv, shape)
    if real:
        out = _real_result(out, a, b)
    return _to_numpy(out) if is_np else out


# ----------------------------------------------------------------------------
# hilbert / resample / correlate
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _hilbert_plan(n: int, axis: int, config: PlanConfig | None):
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return plan_filter(n, response=h, axis=axis, config=config)


def hilbert(x, N: int | None = None, axis: int = -1, *,
            config: PlanConfig | None = None, device=None):
    """Analytic signal via the Hilbert transform
    (scipy.signal.hilbert-compatible): real input -> complex output whose
    real part is x and imaginary part its Hilbert transform. The whole
    ifft(fft(x) * h) pipeline runs through ``plan_filter``: one pass of K10
    for N <= 512 (the one-sided mask is not Hermitian, so its circulant is
    complex)."""
    is_np = not isinstance(x, torch.Tensor)
    if is_np:
        x = np.asarray(x)
        if np.iscomplexobj(x):
            raise ValueError("x must be real")
        if not _is_host_f64(x):  # the f64 tier stays on the host
            x = torch.from_numpy(np.ascontiguousarray(x)).to(
                numpy_device(device))
    elif x.is_complex():
        raise ValueError("x must be real")
    ax = axis % x.ndim
    n0 = x.shape[ax]
    N = n0 if N is None else int(N)
    if N < 1:
        raise ValueError("N must be positive")
    if N < n0:
        sl = [slice(None)] * x.ndim
        sl[ax] = slice(0, N)
        x = x[tuple(sl)]
    elif N > n0:
        if isinstance(x, np.ndarray):
            pad = [(0, 0)] * x.ndim
            pad[ax] = (0, N - n0)
            x = np.pad(x, pad)
        else:
            x = F.pad(x.movedim(ax, -1), (0, N - n0)).movedim(-1, ax)
    out = _hilbert_plan(N, ax, config)(x)
    if is_np and isinstance(out, torch.Tensor):
        return _to_numpy(out)
    return out


def hilbert2(x, N=None, axes=(-2, -1), *,
             config: PlanConfig | None = None, device=None):
    """2-D analytic signal (scipy.signal.hilbert2-compatible): real input
    -> complex output via fft2, the separable h1 (x) h2 one-sided doubling
    mask, and ifft2."""
    is_np = not isinstance(x, torch.Tensor)
    if is_np:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(
            numpy_device(device))
    x = torch.atleast_2d(x)
    if x.is_complex():
        raise ValueError("x must be real.")
    if len(axes) != 2:
        raise ValueError("axes must be a tuple of length 2")
    ax0, ax1 = (a % x.ndim for a in axes)
    if ax0 == ax1:
        raise ValueError("axes must contain 2 distinct axes")
    if N is None:
        N = (x.shape[ax0], x.shape[ax1])
    elif isinstance(N, int):
        if N <= 0:
            raise ValueError("N must be positive.")
        N = (N, N)
    elif len(N) != 2 or any(int(n) <= 0 for n in N):
        raise ValueError("When given as a tuple, N must hold exactly "
                         "two positive integers")
    N = (int(N[0]), int(N[1]))

    def mask1(n):
        h = np.zeros(n)
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
        return h

    X = api.fft2(x, s=N, axes=(ax0, ax1), config=config)
    shape = [1] * x.ndim
    shape[ax0], shape[ax1] = N
    h = torch.as_tensor(np.outer(mask1(N[0]), mask1(N[1])).reshape(shape),
                        dtype=X.real.dtype, device=X.device)
    out = api.ifft2(X * h, axes=(ax0, ax1), config=config)
    return _to_numpy(out) if is_np else out


def resample(x, num: int, axis: int = 0, *,
             config: PlanConfig | None = None, device=None):
    """Fourier-domain resampling (scipy.signal.resample semantics,
    window=None): keep the ``min(num, N)`` lowest-frequency bins with
    scipy's exact Nyquist-bin split/fold, inverse-transform at the new
    length, scale by num/N. Real input -> real output."""
    is_np = not isinstance(x, torch.Tensor)
    if is_np:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(
            numpy_device(device))
    real = not x.is_complex()
    ax = axis % x.ndim
    N = x.shape[ax]
    num = int(num)
    if num < 1:
        raise ValueError("num must be positive")
    X = api.fft(x, axis=ax, config=config)
    newshape = list(X.shape)
    newshape[ax] = num
    n_min = min(num, N)
    nyq = n_min // 2 + 1
    Y = X.new_zeros(newshape)

    def at(index):
        sl = [slice(None)] * x.ndim
        sl[ax] = index
        return tuple(sl)

    Y[at(slice(0, nyq))] = X[at(slice(0, nyq))]
    if n_min > 2:
        neg = n_min - nyq
        Y[at(slice(num - neg, num))] = X[at(slice(N - neg, N))]
    if n_min % 2 == 0:
        half = at(n_min // 2)
        if num < N:  # downsampling: fold the split Nyquist energy back
            Y[half] += X[at(N - num // 2)]
        elif num > N:  # upsampling: split the Nyquist bin symmetrically
            Y[half] *= 0.5
            Y[at(num - n_min // 2)] = Y[half]
    y = api.ifft(Y, axis=ax, config=config) * (num / N)
    if real:
        y = y.real.to(x.dtype if x.is_floating_point() else torch.float32)
    return _to_numpy(y) if is_np else y


def correlate(in1, in2, mode: str = "full", *, axes=None,
              config: PlanConfig | None = None, device=None):
    """FFT-method cross-correlation
    (scipy.signal.correlate(..., method="fft")-compatible):
    correlate(a, b) = convolve(a, conj(b reversed))."""
    is_np = not (isinstance(in1, torch.Tensor)
                 or isinstance(in2, torch.Tensor))
    a, b = _operands(in1, in2, device)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    # reverse (and conjugate) only the correlated axes: flipping a
    # non-correlated batch axis would pair row i with row B-1-i
    caxes = _conv_axes(a.shape, b.shape, axes) if b.ndim else ()
    if caxes:
        b = b.flip(caxes)
    if b.is_complex():
        b = b.conj().resolve_conj()
    out = fftconvolve(a, b, mode=mode, axes=axes, config=config)
    return _to_numpy(out) if is_np else out


def oaconvolve(in1, in2, mode: str = "full", axes=None, *,
               config: PlanConfig | None = None, device=None):
    """Overlap-add convolution (scipy.signal.oaconvolve-compatible
    results). For a single convolution axis with a large length ratio the
    signal runs in fast-length blocks through one batched rfft (one K7
    launch for every block; the kernel's spectrum once) and one batched
    irfft, so the cost scales with N1 log N2. Other configurations delegate
    to fftconvolve (identical results by linearity)."""
    is_np = not (isinstance(in1, torch.Tensor)
                 or isinstance(in2, torch.Tensor))
    a, b = _operands(in1, in2, device)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if a.ndim == 0 or a.numel() == 0 or b.numel() == 0:
        out = fftconvolve(a, b, mode=mode, axes=axes, config=config)
        return _to_numpy(out) if is_np else out
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    caxes = _conv_axes(a.shape, b.shape, axes)
    real = not (a.is_complex() or b.is_complex())
    oa_ok = (len(caxes) == 1
             and max(a.shape[caxes[0]], b.shape[caxes[0]])
             >= 8 * min(a.shape[caxes[0]], b.shape[caxes[0]])
             and min(a.shape[caxes[0]], b.shape[caxes[0]]) >= 2)
    if not oa_ok:
        out = fftconvolve(a, b, mode=mode, axes=axes, config=config)
        return _to_numpy(out) if is_np else out
    ax = caxes[0]
    sig, ker = (a, b) if a.shape[ax] >= b.shape[ax] else (b, a)
    n_sig, n_ker = sig.shape[ax], ker.shape[ax]
    full = n_sig + n_ker - 1
    L = next_fast_len(max(8 * n_ker, 64))
    step = L - (n_ker - 1)
    nblocks = -(-n_sig // step)
    sigm = F.pad(sig.movedim(ax, -1), (0, nblocks * step - n_sig))
    kerm = ker.movedim(ax, -1)
    blocks = sigm.reshape(sigm.shape[:-1] + (nblocks, step))
    if real:
        prod = (api.rfft(blocks, n=L, config=config)
                * api.rfft(kerm, n=L, config=config)[..., None, :])
        YB = api.irfft(prod, n=L, config=config)
    else:
        prod = (api.fft(blocks, n=L, config=config)
                * api.fft(kerm, n=L, config=config)[..., None, :])
        YB = api.ifft(prod, config=config)
    # overlap-add: heads lie end to end; the (n_ker - 1)-long tails shift
    # one block right and accumulate
    lead = YB.shape[:-2]
    heads = YB[..., :step].reshape(lead + (nblocks * step,))
    tails = F.pad(YB[..., step:], (0, step - (n_ker - 1))).reshape(
        lead + (nblocks * step,))
    out = YB.new_zeros(lead + (nblocks * step + step,))
    out[..., :nblocks * step] = heads
    out[..., step:step + nblocks * step] += tails
    conv = out[..., :full].movedim(-1, ax)
    # mode cropping relative to the original in1/in2 roles
    s1, s2 = tuple(a.shape), tuple(b.shape)
    if mode == "valid":
        lo, hi = (s1, s2) if s1[ax] >= s2[ax] else (s2, s1)
        shape = list(conv.shape)
        shape[ax] = lo[ax] - hi[ax] + 1
        conv = _centered(conv, shape)
    elif mode == "same":
        # scipy crops to in1's shape on every axis, broadcast included
        conv = _centered(conv, s1)
    if real:
        conv = _real_result(conv, a, b)
    return _to_numpy(conv) if is_np else conv


def envelope(z, bp_in: tuple = (1, None), *, n_out: int | None = None,
             squared: bool = False, residual: str | None = "lowpass",
             axis: int = -1, config: PlanConfig | None = None, device=None):
    """Envelope of a real or complex signal (scipy.signal.envelope-
    compatible, scipy >= 1.16): bandpass in Fourier space, the analytic
    signal's magnitude out, plus the filtered-away residual, stacked on a
    new leading axis. The transforms run through the port's plans; the
    O(n) spectrum surgery is tensor indexing on the same device."""
    is_np = not isinstance(z, torch.Tensor)
    if is_np:
        z = torch.from_numpy(np.ascontiguousarray(np.asarray(z))).to(
            numpy_device(device))
    if not (-z.ndim <= axis < z.ndim):
        raise ValueError(f"Invalid parameter {axis=} for "
                         f"z.shape={tuple(z.shape)}!")
    n = z.shape[axis]
    if n <= 0:
        raise ValueError(f"z.shape[axis] not > 0 for "
                         f"z.shape={tuple(z.shape)}, {axis=}!")
    if len(bp_in) != 2 or not all(isinstance(b_, int) or b_ is None
                                  for b_ in bp_in):
        raise ValueError(f"{bp_in=} isn't a 2-tuple of type "
                         "(int | None, int | None)!")
    if not ((isinstance(n_out, int) and n_out > 0) or n_out is None):
        raise ValueError(f"{n_out=} is not a positive integer or None!")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"{residual=} not in ['lowpass', 'all', None]!")
    n_out = n if n_out is None else n_out
    fak = n_out / n
    bp = slice(bp_in[0] if bp_in[0] is not None else -(n // 2),
               bp_in[1] if bp_in[1] is not None else (n + 1) // 2)
    if not (-n // 2 <= bp.start < bp.stop <= (n + 1) // 2):
        raise ValueError("`-n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2` does "
                         f"not hold for n={n} and {bp_in=}!")

    zm = z.movedim(axis, -1)
    complex_in = zm.is_complex()
    if complex_in:
        Z = api.fft(zm, axis=-1, config=config)
    else:
        R = api.rfft(zm, axis=-1, config=config)
        Z = R.new_zeros(zm.shape[:-1] + (n,))
        Z[..., :n // 2 + 1] = R
        if bp.start > 0:  # make the bp band analytic
            Z[..., bp] *= 2
        elif bp.stop > 0:
            Z[..., 1:bp.stop] *= 2

    # envelope: baseband the bp band (envelopes are shift-invariant)
    if not (bp.start <= 0 < bp.stop):
        Zbb = Z[..., bp]
    else:
        shifted = torch.roll(Z, n // 2, dims=-1)
        Zbb = shifted[..., bp.start + n // 2:bp.stop + n // 2]
    z_bb = api.ifft(Zbb, n=n_out, axis=-1, config=config) * fak
    env = (z_bb.real ** 2 + z_bb.imag ** 2) if squared else z_bb.abs()
    z_env = env.movedim(-1, axis)
    if residual is None:
        return _to_numpy(z_env) if is_np else z_env

    # zero the bp band; "lowpass" keeps only frequencies below it
    if not (bp.start <= 0 < bp.stop):
        Z[..., bp] = 0
    else:
        Z[..., :bp.stop] = 0
        Z[..., bp.start:] = 0
    if residual == "lowpass":
        if bp.stop > 0:
            Z[..., bp.stop:(n + 1) // 2] = 0
        else:
            Z[..., bp.start:] = 0
            Z[..., :(n + 1) // 2] = 0

    if complex_in:
        z_res = api.ifft(Z, axis=-1, config=config)
        if n_out != n:
            # a frequency-domain resample is a time-domain resample of
            # ifft(Z)
            z_res = resample(z_res, n_out, axis=-1, config=config)
    else:
        if n_out != n and (m := min(n, n_out)) % 2 == 0:
            Z[..., m // 2] *= 2 if n_out < n else 0.5
        z_res = api.irfft(Z[..., :n_out // 2 + 1], n=n_out, axis=-1,
                          config=config) * fak
    z_res = z_res.movedim(-1, axis)
    out = torch.stack((z_env.to(z_res.dtype), z_res), dim=0)
    return _to_numpy(out) if is_np else out
