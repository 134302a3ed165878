"""scipy.signal utility surface (counterpart of ``tpufft/sigtools.py``):
``detrend``, ``deconvolve``, ``wiener``, ``savgol_filter``,
``savgol_coeffs``, ``correlation_lags``, ``choose_conv_method``,
``convolve``, ``convolve2d``, ``correlate2d``, ``order_filter``,
``medfilt``, ``medfilt2d``, ``vectorstrength``.

Device functions: ``wiener`` (each local moment is ONE
``signal.fftconvolve``), ``savgol_filter`` (one batched FFT convolution;
the 'interp' edge fits are host float64 projection matrices applied in
float64) and ``convolve(method="fft")`` take numpy input to ``device``
(None: the CUDA device, ``api.numpy_device``) and give numpy back; a
tensor runs where it lies. ``detrend`` on a tensor runs torch ops on its
device, its least-squares fit written as elementwise sums (a TF32 matmul
would cost the fitted trend about three digits); on numpy it is host
numpy, as are ``deconvolve`` (a sequential long division),
``correlation_lags``, ``savgol_coeffs`` and ``vectorstrength``.

Direct convolution and the rank filters (``order_filter``, ``medfilt``,
``medfilt2d``) are exact: numpy input runs on the host over a zero-copy
sliding-window view, a tensor on its own device over ``unfold`` windows
(``kthvalue`` for the rank filters). Both work in blocks over the leading
axis, so the transient (a block of outputs times the kernel's size) stays
near ``_CHUNK_BYTES``: tpufft's direct convolution builds the whole
outputs x kernel array at once (about 20 GB for a 2000^2 image and a 25^2
kernel).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from numpy.lib.stride_tricks import sliding_window_view

from .api import compute_tensor
from .config import PlanConfig
from .signal import fftconvolve

__all__ = ["detrend", "deconvolve", "wiener", "correlation_lags",
           "choose_conv_method", "savgol_filter", "savgol_coeffs",
           "convolve", "convolve2d", "correlate2d",
           "order_filter", "medfilt", "medfilt2d", "vectorstrength"]

# transient budget of direct convolution and the rank filters: a block of
# outputs times the kernel's size, blocks over the leading axis
_CHUNK_BYTES = 64 << 20


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _take_padded(x, axis: int, before: int, after: int, mode: str):
    """``x`` extended along ``axis`` as ``np.pad(x, mode=mode)`` would
    (reflect, edge, wrap, symmetric), for numpy arrays and tensors."""
    idx = np.pad(np.arange(x.shape[axis]), (before, after), mode=mode)
    if isinstance(x, torch.Tensor):
        return x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return np.take(x, idx, axis=axis)


# ----------------------------------------------------------------------------
# detrend, deconvolve, wiener
# ----------------------------------------------------------------------------

def _lstsq_design(npts: int) -> np.ndarray:
    """scipy's detrend design matrix: [arange(1, npts + 1) / npts, 1]."""
    A = np.ones((npts, 2))
    A[:, 0] = np.arange(1, npts + 1, dtype=np.float64) / npts
    return A


def detrend(data, axis: int = -1, type: str = "linear", bp=0,
            overwrite_data: bool = False):
    """Remove a constant or piecewise-linear trend
    (scipy.signal.detrend-compatible, including breakpoints ``bp``)."""
    if type not in ("linear", "l", "constant", "c"):
        raise ValueError("Trend type must be 'linear' or 'constant'.")
    is_t = isinstance(data, torch.Tensor)
    if is_t:
        if not (data.is_floating_point() or data.is_complex()):
            data = data.to(torch.float32)
    else:
        data = np.asarray(data)
        if not np.issubdtype(data.dtype, np.inexact):
            data = data.astype(np.float64)
    if type in ("constant", "c"):
        if is_t:
            return data - data.mean(axis, keepdim=True)
        return data - np.mean(data, axis=axis, keepdims=True)

    shape = tuple(data.shape)
    axis = axis % data.ndim
    N = shape[axis]
    bp = np.sort(np.unique(np.concatenate(
        [np.atleast_1d(np.asarray(v, np.intp)) for v in (0, bp, N)])))
    if np.any(bp > N):
        raise ValueError("Breakpoints must be less than length of data "
                         "along given axis.")
    moved = data.movedim(axis, 0) if is_t else np.moveaxis(data, axis, 0)
    newdata = moved.reshape(N, -1)
    pieces = []
    for lo, hi in zip(bp[:-1], bp[1:]):
        A = _lstsq_design(int(hi - lo))
        seg = newdata[int(lo):int(hi)]
        if not is_t:
            coef, *_ = np.linalg.lstsq(A, seg, rcond=None)
            pieces.append(seg - A @ coef)
            continue
        # the fit is a host float64 projection, applied as elementwise
        # sums: coef_k = sum_n pinv[k, n] seg[n], trend = A coef
        pinv = np.linalg.pinv(A)
        dev, dt = seg.device, seg.dtype
        rdt = seg.real.dtype
        p = torch.as_tensor(pinv, dtype=rdt, device=dev)
        a0 = torch.as_tensor(A[:, 0], dtype=rdt, device=dev)
        c0 = (seg * p[0][:, None]).sum(0)
        c1 = (seg * p[1][:, None]).sum(0)
        pieces.append((seg - a0[:, None] * c0 - c1).to(dt))
    if is_t:
        out = torch.cat(pieces, 0) if len(pieces) > 1 else pieces[0]
        return out.reshape(moved.shape).movedim(0, axis)
    out = np.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
    return np.moveaxis(out.reshape(moved.shape), 0, axis)


def deconvolve(signal, divisor):
    """Polynomial deconvolution: ``signal = convolve(divisor, quotient)
    + remainder`` (scipy.signal.deconvolve-compatible). A sequential long
    division, run as a host float64 recurrence (the quotient is
    lfilter(num, den, impulse) in scipy's own definition)."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if num.ndim != 1 or num.size == 0:
        raise ValueError("Parameter signal must be non-empty 1d array, "
                         f"but its shape is {np.shape(signal)}!")
    if den.ndim != 1 or den.size == 0:
        raise ValueError("Parameter divisor must be non-empty 1d array, "
                         f"but its shape is {np.shape(divisor)}!")
    if den[0] == 0:
        raise ValueError("divisor cannot have a leading zero")
    N, D = num.size, den.size
    if D > N:
        return np.array([]), num.copy()
    n_out = N - D + 1
    quot = np.empty(n_out)
    a = den / den[0]
    for n in range(n_out):
        k = min(n, D - 1)
        acc = num[n] / den[0]
        if k:
            acc -= a[1:k + 1] @ quot[n - 1::-1][:k]
        quot[n] = acc
    rem = num - np.convolve(den, quot, mode="full")
    return quot, rem


def wiener(im, mysize=None, noise=None, *,
           config: PlanConfig | None = None, device=None):
    """Adaptive Wiener filter (scipy.signal.wiener-compatible): local mean
    and variance from box sums, each ONE FFT convolution, then the
    noise-thresholded gain."""
    if (im.is_complex() if isinstance(im, torch.Tensor)
            else np.iscomplexobj(im)):
        raise NotImplementedError(
            "complex wiener is not supported (filter re/im separately)")
    im, is_np = compute_tensor(im, device)
    if mysize is None:
        mysize = [3] * im.ndim
    mysize = np.atleast_1d(np.asarray(mysize, np.intp))
    if mysize.size == 1:
        mysize = np.full(im.ndim, int(mysize[0]), np.intp)
    if mysize.size != im.ndim:
        raise ValueError("mysize must match the input rank")
    size = float(np.prod(mysize))
    box = im.new_ones(tuple(int(s) for s in mysize))
    lmean = fftconvolve(im, box, mode="same", config=config) / size
    lvar = (fftconvolve(im * im, box, mode="same", config=config) / size
            - lmean * lmean)
    if noise is None:
        noise = lvar.mean()
    res = (im - lmean) * (1 - noise / lvar) + lmean
    out = torch.where(lvar < noise, lmean, res)
    return _numpy(out) if is_np else out


# ----------------------------------------------------------------------------
# Savitzky-Golay
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _savgol_edge_projector(window_length: int, polyorder: int,
                           deriv: int, delta: float, halflen: int):
    """The scipy 'interp' edge fit is a LINEAR map window -> values:
    P = polyval(eval_pts) @ D^deriv @ pinv(vander) / delta^deriv, one
    (halflen, window_length) float64 matrix per edge. The fit runs in the
    centred, normalized variable t' = (t - c0)/s (the raw Vandermonde at
    window 31 costs ~1e-9, centred ~1e-14); each derivative picks up 1/s."""
    t = np.arange(window_length, dtype=np.float64)
    c0 = (window_length - 1) / 2.0
    s = max(c0, 1.0)
    pinvV = np.linalg.pinv(np.vander((t - c0) / s, polyorder + 1,
                                     increasing=True))
    # derivative operator on increasing-power coefficients
    coeffs = np.eye(polyorder + 1)
    for _ in range(deriv):
        coeffs = coeffs[1:] * np.arange(1, coeffs.shape[0])[:, None]

    def proj(pts):
        if coeffs.shape[0] == 0:
            return np.zeros((pts.size, window_length))
        E = np.vander((pts - c0) / s, coeffs.shape[0], increasing=True)
        return (E @ coeffs @ pinvV) / ((delta * s) ** deriv)

    return (proj(np.arange(halflen, dtype=np.float64)),
            proj(np.arange(window_length - halflen, window_length,
                           dtype=np.float64)))


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv"):
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs-
    compatible): the least-squares polynomial fit over the window is a
    LINEAR map, so the deriv-th derivative at ``pos`` is one row of the
    Vandermonde pseudo-inverse scaled by deriv!/delta^deriv. Host f64."""
    window_length = int(window_length)
    polyorder = int(polyorder)
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen if rem else halflen - 0.5
    if not 0 <= pos <= window_length - 1:
        raise ValueError("pos must be nonnegative and less than "
                         "window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if int(deriv) > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    A = x ** np.arange(polyorder + 1).reshape(-1, 1)
    y = np.zeros(polyorder + 1)
    y[int(deriv)] = math.factorial(int(deriv)) / (float(delta)
                                                  ** int(deriv))
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1,
                  mode: str = "interp", cval: float = 0.0, *,
                  config: PlanConfig | None = None, device=None):
    """Savitzky-Golay smoothing/differentiation
    (scipy.signal.savgol_filter-compatible). The FIR core runs as ONE
    batched FFT convolution; the 'interp' edge fits are host float64
    projection matrices applied in float64 (never TF32) to the edge
    windows."""
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError("mode must be 'mirror', 'constant', 'nearest' "
                         "'wrap' or 'interp'.")
    window_length = int(window_length)
    w = savgol_coeffs(window_length, int(polyorder), deriv=int(deriv),
                      delta=float(delta))
    x, is_np = compute_tensor(x, device)
    axis = axis % x.ndim
    n = x.shape[axis]
    c = (window_length - 1) // 2
    cr = window_length - 1 - c
    xm = x.movedim(axis, -1)
    shape = [1] * xm.ndim
    shape[-1] = window_length
    wv = torch.as_tensor(w, dtype=xm.real.dtype,
                         device=xm.device).reshape(shape)
    if mode == "interp":
        if window_length > n:
            raise ValueError("If mode is 'interp', window_length must "
                             "be less than or equal to the size of x.")
        # scipy's interp core always zero-pads (cval applies only to the
        # explicit 'constant' mode); the edge fits overwrite those outputs
        xe = F.pad(xm, (c, cr))
    elif mode == "constant":
        xe = F.pad(xm, (c, cr), value=cval)
    else:
        xe = _take_padded(xm, xm.ndim - 1, c, cr, {
            "mirror": "reflect", "nearest": "edge", "wrap": "wrap"}[mode])
    yc = fftconvolve(xe, wv, mode="full", axes=(-1,), config=config)
    y = yc[..., window_length - 1:window_length - 1 + n]
    if mode == "interp":
        halflen = window_length // 2
        Pl, Pr = _savgol_edge_projector(window_length, int(polyorder),
                                        int(deriv), float(delta), halflen)
        left = _wide(xm[..., :window_length]) @ _wide(
            torch.as_tensor(Pl.T, device=xm.device))
        right = _wide(xm[..., n - window_length:]) @ _wide(
            torch.as_tensor(Pr.T, device=xm.device))
        y = torch.cat([left.to(y.dtype), y[..., halflen:n - halflen],
                       right.to(y.dtype)], -1)
    y = y.movedim(-1, axis)
    return _numpy(y) if is_np else y


# ----------------------------------------------------------------------------
# correlation_lags, choose_conv_method
# ----------------------------------------------------------------------------

def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices for the output of ``correlate``
    (scipy.signal.correlation_lags-compatible)."""
    in1_len, in2_len = int(in1_len), int(in2_len)
    if in1_len < 1 or in2_len < 1:
        raise ValueError("input lengths must be positive")
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - lag_bound:mid + lag_bound]
        return lags[mid - lag_bound:mid + lag_bound + 1]
    if mode == "valid":
        lag_bound = in1_len - in2_len
        if lag_bound >= 0:
            return np.arange(lag_bound + 1)
        return np.arange(lag_bound, 1)
    raise ValueError(f"mode must be full/same/valid, got {mode!r}")


def _kind(x) -> str:
    """numpy's dtype kind of an array or a tensor ('b', 'i', 'f', 'c')."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return "b"
        return "c" if x.is_complex() else "f" if x.is_floating_point() \
            else "i"
    return "i" if x.dtype.kind == "u" else x.dtype.kind


def _size(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else x.size


def _abs_max(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.abs().max().item())
    return int(np.abs(x).max())


def choose_conv_method(in1, in2, mode: str = "full",
                       measure: bool = False, *, device=None):
    """Advise 'fft' or 'direct' convolution
    (scipy.signal.choose_conv_method-compatible contract: exact-integer
    inputs force 'direct' when the products stay representable;
    ``measure=True`` times both on 1-D numpy inputs, the FFT on
    ``device``)."""
    a = in1 if isinstance(in1, torch.Tensor) else np.asarray(in1)
    b = in2 if isinstance(in2, torch.Tensor) else np.asarray(in2)

    def _ints_exact():
        if not (_kind(a) == "i" and _kind(b) == "i"):
            return False
        if _size(a) == 0 or _size(b) == 0:
            return True
        max_val = _abs_max(a) * _abs_max(b) * min(_size(a), _size(b))
        return max_val < 2 ** 52  # f64 mantissa: fft stays exact below

    if measure and isinstance(a, np.ndarray) and isinstance(
            b, np.ndarray) and a.ndim == 1 and b.ndim == 1:
        import timeit

        times = {}
        times["direct"] = min(timeit.repeat(
            lambda: np.convolve(a, b, mode), number=1, repeat=3))
        times["fft"] = min(timeit.repeat(
            lambda: fftconvolve(a.astype(np.float64), b.astype(np.float64),
                                mode, device=device),
            number=1, repeat=3))
        chosen = "fft" if times["fft"] < times["direct"] else "direct"
        return chosen, times
    if measure:
        # N-D and tensor measurement fall back to the heuristic (the
        # answer stays advisory)
        return choose_conv_method(a, b, mode), {}
    if _kind(a) == "i" or _kind(b) == "i":
        return "direct" if not _ints_exact() else (
            "fft" if max(_size(a), _size(b)) > 500 else "direct")
    # float heuristic: direct only for tiny operands
    return "fft" if min(_size(a), _size(b)) > 32 or \
        max(_size(a), _size(b)) > 4096 else "direct"


# ----------------------------------------------------------------------------
# convolve, convolve2d, correlate2d
# ----------------------------------------------------------------------------

def _windows(vol, shape):
    """The zero-copy sliding windows of ``vol`` (out + shape)."""
    if isinstance(vol, torch.Tensor):
        for d, k in enumerate(shape):
            vol = vol.unfold(d, k, 1)
        return vol
    return sliding_window_view(vol, shape)


def _zero_pad(x, pads):
    """``x`` zero-padded by (before, after) per axis."""
    if isinstance(x, torch.Tensor):
        return F.pad(x, [p for pair in reversed(pads) for p in pair])
    return np.pad(x, pads)


def _direct_convolve_nd(vol, ker, mode: str):
    """Exact direct N-D convolution over sliding windows, in blocks over
    the leading axis whose transient (block outputs x kernel size) stays
    near ``_CHUNK_BYTES``. numpy: ``tensordot`` on the host (integers stay
    integers, bool is the OR-convolution); tensors: an elementwise product
    and sum on the tensor's device."""
    nd = vol.ndim
    is_t = isinstance(vol, torch.Tensor)
    kshape = tuple(ker.shape)
    if mode != "valid":
        vol = _zero_pad(vol, [(k - 1, k - 1) for k in kshape])
    win = _windows(vol, kshape)
    if mode == "same":
        # the centred crop to the first input's shape (np.convolve's)
        win = win[tuple(slice((k - 1) // 2, (k - 1) // 2 + n - 2 * (k - 1))
                        for n, k in zip(vol.shape, kshape))]
    if is_t:
        flip = ker.flip(list(range(nd)))
        out = torch.empty(win.shape[:nd], device=win.device,
                          dtype=torch.promote_types(vol.dtype, ker.dtype))
        itemsize = out.element_size()
    else:
        flip = ker[(slice(None, None, -1),) * nd]
        out = np.empty(win.shape[:nd], np.result_type(vol, ker))
        itemsize = out.itemsize
    row = max(1, math.prod(out.shape[1:]) * math.prod(kshape) * itemsize)
    step = max(1, _CHUNK_BYTES // row)
    for lo in range(0, out.shape[0], step):
        blk = win[lo:lo + step]
        if is_t:
            out[lo:lo + step] = (blk * flip).sum(
                tuple(range(nd, 2 * nd)))
        else:
            out[lo:lo + step] = np.tensordot(blk, flip, axes=nd)
    return out


def _valid_swap(mode: str, s1, s2):
    """scipy's operand-swap rule: 'valid' needs one operand to dominate
    the other in every dimension; convolution commutes, so the bigger one
    leads."""
    if mode != "valid":
        return False
    ok1 = all(a >= b for a, b in zip(s1, s2))
    ok2 = all(b >= a for a, b in zip(s1, s2))
    if not (ok1 or ok2):
        raise ValueError("For 'valid' mode, one input must be at least "
                         "as large as the other in every dimension")
    return ok2 and not ok1


def convolve(in1, in2, mode: str = "full", method: str = "auto", *,
             device=None):
    """N-D convolution (scipy.signal.convolve-compatible).

    ``method='auto'`` picks via :func:`choose_conv_method`; ``'fft'`` runs
    ``signal.fftconvolve`` (numpy on ``device``), with integer and bool
    results rounded back to the integer lattice (for bool that is the
    OR-convolution scipy's direct method computes); ``'direct'`` is exact,
    on the host for numpy and on the tensor's device for tensors."""
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"invalid mode {mode!r}")
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    is_t = isinstance(in1, torch.Tensor) or isinstance(in2, torch.Tensor)
    if is_t:
        dev = (in1 if isinstance(in1, torch.Tensor) else in2).device
        a, b = (x if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev)
                for x in (in1, in2))
    else:
        a, b = np.asarray(in1), np.asarray(in2)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if _size(a) == 0 or _size(b) == 0:
        raise ValueError("empty inputs are not supported")
    if method == "auto":
        method = choose_conv_method(a, b, mode)
    if method == "direct":
        if _valid_swap(mode, tuple(a.shape), tuple(b.shape)):
            a, b = b, a
        return _direct_convolve_nd(a, b, mode)
    _valid_swap(mode, tuple(a.shape), tuple(b.shape))  # validate only
    exact = _kind(a) in "ib" and _kind(b) in "ib"
    if is_t:
        if not exact:
            return fftconvolve(a, b, mode=mode)
        rt = torch.promote_types(a.dtype, b.dtype)
        out = fftconvolve(a.double(), b.double(), mode=mode).round()
        return out != 0 if rt == torch.bool else out.to(rt)
    rt = np.result_type(a, b)
    if exact:
        out = fftconvolve(np.asarray(a, np.float64),
                          np.asarray(b, np.float64), mode=mode,
                          device=device)
        return np.around(out).astype(rt)
    return np.asarray(fftconvolve(a, b, mode=mode, device=device)).astype(
        rt, copy=False)


_BOUNDARY_PAD = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


def _conv2d_args(in1, in2, mode: str, boundary: str):
    a = in1 if isinstance(in1, torch.Tensor) else np.asarray(in1)
    k = in2 if isinstance(in2, torch.Tensor) else np.asarray(in2)
    if a.ndim != 2 or k.ndim != 2:
        raise ValueError("convolve2d/correlate2d inputs must be 2-D")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"invalid mode {mode!r}")
    if boundary not in _BOUNDARY_PAD:
        raise ValueError(f"invalid boundary {boundary!r}")
    return a, k


def _extend2d(a, kshape, boundary: str, fillvalue):
    """``a`` extended by kernel-1 samples a side with the boundary rule."""
    pads = [(k - 1, k - 1) for k in kshape]
    if boundary == "fill":
        if isinstance(a, torch.Tensor):
            return F.pad(a, [p for pair in reversed(pads) for p in pair],
                         value=fillvalue)
        return np.pad(a, pads, constant_values=fillvalue)
    for ax, (p, _) in enumerate(pads):
        a = _take_padded(a, ax, p, p, _BOUNDARY_PAD[boundary])
    return a


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0, *, device=None):
    """2-D convolution with boundary handling
    (scipy.signal.convolve2d-compatible).

    Non-zero boundaries extend the INPUT by kernel-1 samples with the
    boundary rule (constant fill / periodic wrap / symmetric reflection),
    so the window math is the zero-pad case's; 'valid' mode never reaches
    the boundary and skips the extension."""
    a, k = _conv2d_args(in1, in2, mode, boundary)
    if (boundary == "fill" and fillvalue == 0) or mode == "valid":
        return convolve(a, k, mode=mode, device=device)
    if boundary in ("wrap", "symm") and any(
            p > s for p, s in zip((k.shape[0] - 1, k.shape[1] - 1),
                                  a.shape)):
        raise ValueError("kernel must not be larger than the input for "
                         "wrap/symm boundaries")
    full = convolve(_extend2d(a, tuple(k.shape), boundary, fillvalue), k,
                    mode="valid", device=device)
    if mode == "full":
        return full
    return full[tuple(slice((kk - 1) // 2, (kk - 1) // 2 + n)
                      for n, kk in zip(a.shape, k.shape))]


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0, *, device=None):
    """2-D cross-correlation with boundary handling
    (scipy.signal.correlate2d-compatible):
    correlate2d(a, k) = convolve2d(a, conj(k[::-1, ::-1])).

    'same' mode crops the full correlation starting at K//2 per axis —
    scipy's correlate2d centring, which differs from the 1-D correlate's
    (K-1)//2 for even kernel lengths."""
    a, k = _conv2d_args(in1, in2, mode, boundary)
    if isinstance(k, torch.Tensor):
        kf = k.flip((0, 1))
        kf = kf.conj().resolve_conj() if kf.is_complex() else kf
    else:
        kf = np.ascontiguousarray(np.conj(k[::-1, ::-1])
                                  if np.iscomplexobj(k) else k[::-1, ::-1])
    if mode == "same":
        full = convolve2d(a, kf, mode="full", boundary=boundary,
                          fillvalue=fillvalue, device=device)
        return full[tuple(slice(kk // 2, kk // 2 + n)
                          for n, kk in zip(a.shape, k.shape))]
    return convolve2d(a, kf, mode=mode, boundary=boundary,
                      fillvalue=fillvalue, device=device)


# ----------------------------------------------------------------------------
# Rank-order filters and vectorstrength
# ----------------------------------------------------------------------------

def _rank_filter(a, domain: np.ndarray, rank: int):
    """Element ``rank`` of the sorted neighbourhood selected by the
    nonzero cells of ``domain`` (zero-padded borders), in blocks over the
    leading axis."""
    nd = a.ndim
    kshape = domain.shape
    win = _windows(_zero_pad(a, [((k - 1) // 2, k - 1 - (k - 1) // 2)
                                 for k in kshape]), kshape)
    sel = np.flatnonzero(domain.ravel())
    is_t = isinstance(a, torch.Tensor)
    if is_t:
        out = torch.empty_like(a)
        itemsize = a.element_size()
        sel_t = torch.as_tensor(sel, device=a.device)
    else:
        out = np.empty(a.shape, a.dtype)
        itemsize = a.dtype.itemsize
    row = max(1, math.prod(a.shape[1:]) * domain.size * itemsize)
    step = max(1, _CHUNK_BYTES // row)
    for lo in range(0, a.shape[0], step):
        blk = win[lo:lo + step]
        flat = blk.reshape(blk.shape[:nd] + (-1,))
        if is_t:
            vals = flat if sel.size == domain.size \
                else flat.index_select(-1, sel_t)
            out[lo:lo + step] = vals.kthvalue(rank + 1, -1).values
        else:
            vals = flat[..., sel]
            out[lo:lo + step] = np.partition(vals, rank, axis=-1)[..., rank]
    return out


def _volume(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def order_filter(a, domain, rank: int):
    """Rank-order filter (scipy.signal.order_filter-compatible): sort the
    neighbourhood selected by the nonzero cells of ``domain`` and keep
    element ``rank``; borders are zero-padded. A tensor is filtered on its
    own device."""
    a = _volume(a)
    domain = np.asarray(domain.cpu() if isinstance(domain, torch.Tensor)
                        else domain)
    if a.ndim != domain.ndim:
        raise ValueError("domain must have the same rank as the input")
    if any(k % 2 != 1 for k in domain.shape):
        raise ValueError("every domain dimension must be odd")
    size = int(np.count_nonzero(domain))
    if not 0 <= rank < size:
        raise ValueError(f"rank must be in [0, {size})")
    return _rank_filter(a, domain, rank)


def medfilt(volume, kernel_size=None):
    """Median filter (scipy.signal.medfilt-compatible): the median over an
    odd kernel window per axis, zero-padded borders. A tensor is filtered
    on its own device."""
    a = _volume(volume)
    if kernel_size is None:
        kernel_size = [3] * a.ndim
    ks = np.atleast_1d(np.asarray(kernel_size, np.intp))
    if ks.size == 1:
        ks = np.full(a.ndim, ks[0])
    if ks.size != a.ndim:
        raise ValueError("kernel_size must match the input rank")
    if np.any(ks % 2 != 1):
        raise ValueError("every kernel_size must be odd")
    domain = np.ones(tuple(ks), np.int8)
    return _rank_filter(a, domain, int(np.prod(ks)) // 2)


def medfilt2d(input, kernel_size=3):
    """2-D median filter (scipy.signal.medfilt2d-compatible)."""
    a = _volume(input)
    if a.ndim != 2:
        raise ValueError("medfilt2d needs a 2-D input")
    return medfilt(a, kernel_size)


def vectorstrength(events, period):
    """Vector strength and mean phase of events against a period
    (scipy.signal.vectorstrength-compatible): magnitude and angle of the
    mean unit phasor exp(2*pi*j*events/period); an array of periods
    returns one row per period. Host numpy."""
    events = np.asarray(events)
    period = np.asarray(period)
    if events.ndim > 1:
        raise ValueError("events must be a 1-D array")
    if period.ndim > 1:
        raise ValueError("period must be a scalar or 1-D array")
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    scalar = period.ndim == 0
    p = np.atleast_1d(period).astype(np.float64)
    ang = 2 * np.pi * events[None, :] / p[:, None]
    ph = np.exp(1j * ang).mean(axis=-1)
    strength = np.abs(ph)
    phase = np.angle(ph)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase
