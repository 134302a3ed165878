"""Polyphase multirate resampling (counterpart of ``tpufft/multirate.py``;
scipy.signal semantics): ``upfirdn``, ``resample_poly``, ``decimate``.

``upfirdn`` is zero-stuff -> linear convolution -> stride. The convolution
is ONE batched ``signal.fftconvolve`` along the axis (the r2c/c2r kernels
K7/K8 on f32 tensors, with fast-length padding). Boundary modes are a small
edge extension on the device (the filter reaches only ceil((len(h)-1)/up)
input samples past each edge), rounded so that the cropped output realigns
on an integer stride offset. Filter design (``firwin``) is a host float64
constant (``design.py``).

Input forms: a tensor runs where it lies and returns a tensor (float32 and
float64, and their complex types, keep their dtype; other dtypes compute
in float32); numpy input runs on ``device`` (None: the CUDA device,
``api.numpy_device``) in its float dtype (float64 for integers) and comes
back as numpy.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from .api import compute_tensor
from .config import PlanConfig
from .design import cheby1, firwin
from .iir import sosfilt, sosfiltfilt
from .signal import fftconvolve

__all__ = ["upfirdn", "resample_poly", "decimate"]


_UPFIRDN_MODES = ("constant", "wrap", "edge", "smooth", "symmetric",
                  "reflect", "antisymmetric", "antireflect", "line")


def _output_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """scipy.signal._upfirdn._output_len: samples the strided output keeps
    from the full upsampled convolution."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _edge_blocks(x: torch.Tensor, n_ext: int, mode: str, cval, axis: int):
    """(left, right) extension blocks of length n_ext along ``axis``
    (scipy _upfirdn boundary semantics)."""
    n = x.shape[axis]

    def take(start, length):
        return x.narrow(axis, start, length)

    if mode == "constant":
        shape = list(x.shape)
        shape[axis] = n_ext
        blk = x.new_full(shape, cval)
        return blk, blk
    if n_ext >= n and mode in ("symmetric", "reflect", "antisymmetric",
                               "antireflect"):
        raise ValueError(
            f"upfirdn mode {mode!r} needs the signal to be longer than "
            f"the boundary extension ({n_ext} samples); got length {n}")
    reps = [1] * x.ndim
    reps[axis] = n_ext
    first, last = take(0, 1), take(n - 1, 1)
    if mode == "edge":
        return first.repeat(reps), last.repeat(reps)
    if mode == "wrap":
        # the signal repeats as often as the extension needs
        idx = torch.arange(-n_ext, 0, device=x.device) % n
        return (x.index_select(axis, idx),
                x.index_select(axis, torch.arange(n_ext, device=x.device)
                               % n))
    if mode in ("symmetric", "antisymmetric"):
        left, right = take(0, n_ext).flip(axis), take(n - n_ext,
                                                      n_ext).flip(axis)
        return (left, right) if mode == "symmetric" else (-left, -right)
    if mode in ("reflect", "antireflect"):
        left = take(1, n_ext).flip(axis)
        right = take(n - n_ext - 1, n_ext).flip(axis)
        if mode == "reflect":
            return left, right
        return 2 * first - left, 2 * last - right
    # line: the linear trend through the first and last points; smooth:
    # each edge's slope from its last two points
    if mode == "line":
        slope_l = slope_r = (last - first) / max(n - 1, 1)
    else:
        slope_l = take(1, 1) - first if n > 1 else 0 * first
        slope_r = last - take(n - 2, 1) if n > 1 else 0 * last
    shape = [1] * x.ndim
    shape[axis] = n_ext
    k = torch.arange(1, n_ext + 1, device=x.device, dtype=x.dtype)
    return (first - k.flip(0).reshape(shape) * slope_l,
            last + k.reshape(shape) * slope_r)


def _zero_stuff(x: torch.Tensor, up: int, axis: int) -> torch.Tensor:
    """Insert up-1 zeros between samples along ``axis`` (length n*up)."""
    if up == 1:
        return x
    shape = list(x.shape)
    xe = x.unsqueeze(axis + 1)
    pad = [0, 0] * (x.ndim - axis - 1) + [0, up - 1]
    shape[axis] *= up
    return torch.nn.functional.pad(xe, pad).reshape(shape)


def _upfirdn(h: np.ndarray, x: torch.Tensor, up: int, down: int, axis: int,
             mode: str, cval, config) -> torch.Tensor:
    axis = axis % x.ndim
    n_in = x.shape[axis]
    if n_in == 0:
        raise ValueError("input must have at least one sample along axis")
    len_h = h.size
    L = _output_len(len_h, n_in, up, down)
    shift = 0
    if not (mode == "constant" and cval == 0):
        # round the extension up so the cropped output realigns on an
        # integer stride offset ((E*up) % down == 0)
        E = -(-(len_h - 1) // up) if len_h > 1 else 0
        while E and (E * up) % down:
            E += 1
        if E:
            left, right = _edge_blocks(x, E, mode, cval, axis)
            x = torch.cat([left, x, right], axis)
            shift = (E * up) // down
    dt = x.dtype
    if np.iscomplexobj(h) and not x.is_complex():
        dt = torch.complex128 if dt == torch.float64 else torch.complex64
        x = x.to(dt)
    hshape = [1] * x.ndim
    hshape[axis] = len_h
    hx = torch.as_tensor(h, device=x.device).to(dt).reshape(hshape)
    y = fftconvolve(_zero_stuff(x, up, axis), hx, mode="full", axes=(axis,),
                    config=config)
    return y.narrow(axis, shift * down, (L - 1) * down + 1)[
        (slice(None),) * axis + (slice(None, None, down),)]


def upfirdn(h, x, up: int = 1, down: int = 1, axis: int = -1,
            mode: str = "constant", cval: float = 0, *,
            config: PlanConfig | None = None, device=None):
    """Upsample by ``up`` (zero insertion), FIR filter with ``h``,
    downsample by ``down`` (scipy.signal.upfirdn-compatible, including the
    output length and the boundary ``mode``/``cval`` semantics). Runs as
    ONE batched FFT convolution."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    h_arr = np.asarray(h)
    if h_arr.ndim != 1 or h_arr.size == 0:
        raise ValueError("h must be 1-D with non-zero length")
    if mode not in _UPFIRDN_MODES:
        raise ValueError(f"mode must be one of {list(_UPFIRDN_MODES)}, "
                         f"got {mode!r}")
    x, is_np = compute_tensor(x, device)
    y = _upfirdn(h_arr, x, up, down, axis, mode, cval, config)
    return y.cpu().numpy() if is_np else y


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's median along ``dim`` (the mean of the two middle values at
    an even count), keepdims."""
    n = x.shape[dim]
    hi = x.kthvalue(n // 2 + 1, dim, keepdim=True).values
    if n % 2:
        return hi
    return (x.kthvalue(n // 2, dim, keepdim=True).values + hi) / 2


def _resample_poly(x: torch.Tensor, up: int, down: int, axis: int, window,
                   padtype: str, cval, config) -> torch.Tensor:
    axis = axis % x.ndim
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == down == 1:
        return x.clone()
    n_in = x.shape[axis]
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    if isinstance(window, (list, np.ndarray, torch.Tensor)):
        h = np.array(window.cpu() if isinstance(window, torch.Tensor)
                     else window, np.float64)
        if h.ndim > 1:
            raise ValueError("window must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        # linear-phase lowpass at the tighter of the two rates
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    h = h * up

    # zero-pad the filter so output samples land centered on the input
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (_output_len(h.size + n_pre_pad + n_post_pad, n_in, up, down)
           < n_out + n_pre_remove):
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])

    funcs = {"mean": lambda t: t.mean(axis, keepdim=True),
             "median": lambda t: _median(t, axis),
             "minimum": lambda t: t.amin(axis, keepdim=True),
             "maximum": lambda t: t.amax(axis, keepdim=True)}
    mode, pad_cval = "constant", 0.0
    background = None
    if padtype in funcs:
        background = funcs[padtype](x)
        x = x - background
    elif padtype in _UPFIRDN_MODES:
        mode, pad_cval = padtype, 0.0 if cval is None else cval
    else:
        raise ValueError(
            "padtype must be one of: maximum, mean, median, minimum, "
            + ", ".join(_UPFIRDN_MODES))
    y = _upfirdn(h, x, up, down, axis, mode, pad_cval, config)
    y = y.narrow(axis, n_pre_remove, n_out)
    return y if background is None else y + background.to(y.dtype)


def resample_poly(x, up: int, down: int, axis: int = 0,
                  window=("kaiser", 5.0), padtype: str = "constant",
                  cval: float | None = None, *,
                  config: PlanConfig | None = None, device=None):
    """Polyphase resampling by the rational factor up/down
    (scipy.signal.resample_poly-compatible: the same firwin kaiser design,
    group-delay centring, padtype background handling)."""
    if up != int(up) or down != int(down):
        raise ValueError("up and down must be integers")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    if cval is not None and padtype != "constant":
        raise ValueError("cval has no effect when padtype is " + padtype)
    x, is_np = compute_tensor(x, device)
    y = _resample_poly(x, up, down, axis, window, padtype, cval, config)
    return y.cpu().numpy() if is_np else y


def decimate(x, q: int, n: int | None = None, ftype: str = "iir",
             axis: int = -1, zero_phase: bool = True, *,
             config: PlanConfig | None = None, device=None):
    """Downsample after an anti-aliasing filter
    (scipy.signal.decimate-compatible).

    ftype='fir': an order-20q hamming firwin; zero_phase aligns the group
    delay through ``resample_poly`` (scipy's own definition). ftype='iir':
    an order-8 Chebyshev-I, run through ``iir.sosfiltfilt`` (zero_phase) or
    ``iir.sosfilt`` on the log-depth scan."""
    q = operator.index(q)
    if q < 1:
        raise ValueError("q must be a positive integer")
    if n is not None:
        n = operator.index(n)
    if ftype not in ("fir", "iir"):
        raise ValueError("invalid ftype (expected 'fir' or 'iir')")
    x, is_np = compute_tensor(x, device)
    axis = axis % x.ndim
    if ftype == "fir":
        b = firwin((2 * (10 * q) if n is None else n) + 1, 1.0 / q,
                   window="hamming")
        if zero_phase:
            y = _resample_poly(x, 1, q, axis, b, "constant", None, config)
        else:
            n_out = x.shape[axis] // q + bool(x.shape[axis] % q)
            y = _upfirdn(b, x, 1, q, axis, "constant", 0, config)
            y = y.narrow(axis, 0, n_out)
    else:
        sos = cheby1(8 if n is None else n, 0.05, 0.8 / q, output="sos")
        y = sosfiltfilt(sos, x, axis=axis) if zero_phase \
            else sosfilt(sos, x, axis=axis)
        y = y[(slice(None),) * axis + (slice(None, None, q),)]
    return y.cpu().numpy() if is_np else y
