"""Public API: plans, the complex and real FFT functions and the Hermitian
family (counterpart of ``tpufft/api.py``).

Complex data crosses this boundary in three forms, and the output form
follows the input form:

* a torch tensor (complex or real) -> a complex tensor on the same device;
* ``SplitComplex(re, im)`` planes -> ``SplitComplex`` planes;
* a numpy array -> a numpy complex array, computed on the plan's
  ``device``: the CUDA device unless the caller names another
  (``device="cpu"``); with no CUDA device a numpy call that names none
  raises RuntimeError (:func:`numpy_device`), it never runs on the CPU
  unasked.

A ``c2r`` plan returns its real plane: a real tensor, a real numpy array,
or ``SplitComplex(out, zeros)``; an ``r2c`` plan refuses complex input
with TypeError. Tensors and ``SplitComplex`` planes run where they lie.

Ported so far: c2c, r2c and c2r plans over any set of axes, the four
norms, ``n``/``s`` crop and zero-pad (including "fast"/"fast-aligned"),
explicit ``bases``, ``PlanConfig`` and autograd; rfft/irfft/rfftn/irfftn/
rfft2/irfft2 and the hfft family, and the host helpers ``fftfreq``,
``rfftfreq``, ``fftshift``, ``ifftshift``. When a plan's last three axes
are the array's three minor axes and the cube fits the cube kernel, they
run in one pass (tpufft's ``cube_last`` rule); else when its last two are
the two minor axes and fit the pair kernel, they do (``pair_last``); two
adjacent middle axes in front of the minor one run in one mid-pair pass;
a zero-padded minor axis pads inside its kernel's load (tpufft's
``pad_fused`` and ``pair_pad`` rules). Each fusion follows the port's own
kernel envelopes, so a shape tpufft fuses may run in more passes here,
with the same result. The transform-major and lane-fused layouts raise
NotImplementedError.

The layers above the transforms live beside this module, with the same
input forms and the same ``device`` rule: ``signal`` (``plan_filter``,
``FilterPlan``, ``fftconvolve``, ``oaconvolve``, ``correlate``,
``hilbert``, ``hilbert2``, ``resample``, ``envelope``), ``realtrans``
(``dct``, ``idct``, ``dst``, ``idst`` and their n-D forms), ``czt``
(``CZT``, ``ZoomFFT``, ``czt``, ``zoom_fft``, ``czt_points``) and
``fhtlog`` (``fht``, ``ifht``, ``fhtoffset``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import execute as _execute
from .config import PlanConfig
from .core import SplitComplex, dtype_name, real_dtype_for
from .planner import default_bases, next_fast_len, validate_bases

__all__ = [
    "Plan",
    "PrecisionDowngradeWarning",
    "SplitComplex",
    "plan_fft",
    "numpy_device",
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = (None, "backward", "ortho", "forward")
_LAYOUTS = ("natural", "transform-major", "lane-fused")


class PrecisionDowngradeWarning(UserWarning):
    """A float64/complex128 plan would compute in float32.

    tpufft warns with it at plan time when JAX's x64 mode is off (a TPU has
    no float64). PyTorch computes float64 natively on the CPU and the GPU,
    so no plan of the port downgrades and the port never warns with it; it
    is exported so that code which filters or catches tpufft's warning runs
    unchanged."""


def numpy_device(device=None) -> torch.device:
    """The device that numpy input runs on: ``device``, or the CUDA device
    when it is None. Raises RuntimeError when that is a CUDA device and
    there is none: numpy input never runs on the CPU unless the caller
    names it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "numpy input runs on the CUDA device unless a device is named, "
            "and there is none: pass device='cpu' to run on the CPU")
    return dev


def _norm_scale(norm, n_total: int, inverse: bool) -> float:
    """Total scaling for a transform over n_total points (numpy conventions)."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    norm = norm or "backward"
    if norm == "ortho":
        return 1.0 / math.sqrt(n_total)
    if (norm == "backward" and inverse) or (norm == "forward" and not inverse):
        return 1.0 / n_total
    return 1.0


def _canon_axes(ndim: int, axes) -> tuple[int, ...]:
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    for a in axes:
        if not -ndim <= a < ndim:
            raise ValueError(f"axis {a} out of range for ndim {ndim}")
    axes = tuple(a % ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"repeated axes in {axes}")
    return axes


def _resize_axis(x, n: int, axis: int):
    """Crop or zero-pad ``x`` to length ``n`` along ``axis``."""
    if x is None:
        return None
    cur = x.shape[axis]
    if cur == n:
        return x
    if cur > n:
        return x.narrow(axis, 0, n)
    pad_shape = list(x.shape)
    pad_shape[axis] = n - cur
    return torch.cat([x, x.new_zeros(pad_shape)], dim=axis)


def _resolve_bases(lengths, bases, cfg: PlanConfig):
    if bases is None:
        return tuple(default_bases(n, cfg.max_radix) for n in lengths)
    if bases and isinstance(bases[0], (int, np.integer)):
        bases = [bases]
    if len(bases) != len(lengths):
        raise ValueError(
            f"need one radix list per transformed axis ({len(lengths)}), "
            f"got {len(bases)}"
        )
    return tuple(validate_bases(n, b) for n, b in zip(lengths, bases))


def _resolve_fast_length(v, current: int) -> int:
    """One ``s``/``n`` entry: an int, "fast" or "fast-aligned"."""
    if isinstance(v, str):
        if v == "fast":
            return next_fast_len(current)
        if v == "fast-aligned":
            return next_fast_len(current, aligned=True)
        raise ValueError(
            f"length spec must be an int, 'fast' or 'fast-aligned', got {v!r}"
        )
    return int(v)


def _axes_from_s(s, axes):
    """``s`` given with ``axes=None`` applies to the LAST len(s) axes."""
    if axes is None and s is not None and not isinstance(s, str):
        return tuple(range(-len(s), 0))
    return axes


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable FFT plan: shapes, per-axis radix schedules, direction,
    normalization, configuration, and the device numpy input is moved to
    (None: the CUDA device).
    """

    shape: tuple[int, ...]
    dtype: str
    axes: tuple[int, ...]
    lengths: tuple[int, ...]           # transform length per axis (after resize)
    bases: tuple[tuple[int, ...], ...]
    inverse: bool
    norm: str | None
    kind: str                          # "c2c", "r2c" or "c2r"
    config: PlanConfig
    device: str | None = None

    def __call__(self, x):
        """Execute the plan; the output form follows the input form, and a
        c2r plan returns its real plane."""
        split_io = isinstance(x, SplitComplex)
        numpy_io = not split_io and not isinstance(x, torch.Tensor)
        ar, ai = self._split_input(x)
        rdt = real_dtype_for(self.dtype)
        if self.config.plane_dtype == "bfloat16" and rdt == torch.float32:
            rdt = torch.bfloat16
        ar = ar.to(rdt)
        ai = None if ai is None else ai.to(rdt)
        outr, outi = _apply_plan_split(ar, ai, plan=self)
        if self.kind == "c2r":
            if split_io:
                return SplitComplex(outr, torch.zeros_like(outr))
            if outr.dtype == torch.bfloat16:
                outr = outr.float()
            return outr.detach().cpu().numpy() if numpy_io else outr
        out = SplitComplex(outr, outi)
        if split_io:
            return out
        if numpy_io:
            return out.numpy()
        return out.complex()

    def _split_input(self, x):
        r2c = self.kind == "r2c"
        if isinstance(x, SplitComplex):
            if r2c:
                raise TypeError("rfft requires real input, got SplitComplex")
            ar, ai = x.re, x.im
        elif isinstance(x, tuple):
            raise TypeError(
                "pass plane pairs as SplitComplex(re, im), not a bare tuple"
            )
        elif isinstance(x, torch.Tensor):
            if x.is_complex() and r2c:
                raise TypeError(
                    f"rfft requires real input, got dtype {x.dtype}")
            ar, ai = (x.real, x.imag) if x.is_complex() else (x, None)
        else:
            xn = np.asarray(x)

            def host(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    numpy_device(self.device))

            if np.iscomplexobj(xn):
                if r2c:
                    raise TypeError(
                        f"rfft requires real input, got dtype {xn.dtype}")
                ar, ai = host(xn.real), host(xn.imag)
            else:
                ar, ai = host(xn), None
        if tuple(ar.shape) != self.shape:
            raise ValueError(
                f"plan was built for shape {self.shape}, got {tuple(ar.shape)}"
            )
        return ar, ai

    @property
    def out_shape(self) -> tuple[int, ...]:
        shape = list(self.shape)
        for a, n in zip(self.axes, self.lengths):
            shape[a] = n
        if self.kind == "r2c":
            shape[self.axes[-1]] = self.lengths[-1] // 2 + 1
        return tuple(shape)


def _apply_plan_split(ar, ai, *, plan: Plan):
    """Crop/pad every axis, then transform (tpufft's ``_apply_plan_split``).
    A zero-padded minor axis pads inside its kernel's load: K9 for a single
    axis (``pad_fused``), K4's ``n2_in`` for the trailing pair
    (``pair_pad``); those passes run first. Then the single axes in order,
    two adjacent middle axes in one mid-pair pass (K6) where
    :func:`execute.mid_pair_ok` holds, and last the trailing cube in one
    pass (K5, ``cube_last``) or the trailing pair (K4, ``pair_last``) where
    they fit. The whole normalization is folded into one pass: the cube's
    or the pair's when it runs, else the last single or mid-pair pass. A
    single axis of length 1 that takes no scale is the identity and is
    skipped.

    The routes come from the port's own envelopes, not tpufft's TPU rules:
    a cube that tpufft fuses and K5 does not hold (e.g. 128 x 128 x 64,
    more than a cluster's shared memory) runs the trailing pair and then
    its leading axis, and the mid pair needs no lane-aligned L, only
    ``L >= execute.MID_PAIR_MIN_L``. The results are the same on every
    route."""
    axes, lengths = plan.axes, plan.lengths
    scale = _norm_scale(plan.norm, math.prod(lengths), plan.inverse)
    if plan.kind == "r2c":
        return _apply_r2c(ar, plan, scale)
    if plan.kind == "c2r":
        return _apply_c2r(ar, ai, plan, scale)
    ndim = ar.ndim
    tgt = list(ar.shape)
    for a, n in zip(axes, lengths):
        tgt[a] = n
    cfg = plan.config
    cube_last = (
        len(axes) >= 3
        and set(axes[-3:]) == {ndim - 3, ndim - 2, ndim - 1}
        and _execute.cube_supported(tgt[-3], tgt[-2], tgt[-1], ar.dtype, cfg)
    )
    pair_last = not cube_last and (
        len(axes) >= 2
        and set(axes[-2:]) == {ndim - 2, ndim - 1}
        and _execute.pair_supported(tgt[-2], tgt[-1], ar.dtype, cfg)
    )
    n_single = len(axes) - (3 if cube_last else (2 if pair_last else 0))
    pad_fused = False   # the minor axis is a single axis padded by K9
    pair_pad = None     # the pair's minor axis is padded by K4 to this
    for i, (a, n) in enumerate(zip(axes, lengths)):
        cur = ar.shape[a]
        if a == ndim - 1 and cur < n:
            if i < n_single and _execute.pad_axis_ok(cur, n, ar.dtype, cfg):
                pad_fused = True
                continue
            if (pair_last and i >= n_single
                    and _execute.pair_pad_ok(tgt[-2], cur, n, ar.dtype,
                                             cfg)):
                pair_pad = n
                continue
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    if pair_pad is not None:
        ar, ai = _execute.fft_pair_last(ar, ai, inverse=plan.inverse,
                                        scale=scale, n2_out=pair_pad)
    order = [i for i in range(n_single) if pad_fused and axes[i] == ndim - 1]
    order += [i for i in range(n_single) if i not in order]
    # adjacent single axes (ndim - 3, ndim - 2) fuse into one mid-pair pass
    # over the (pre, n1, n2, L) view, L the minor dim (tpufft's pairing)
    mid_second = {}
    cand = [i for i in range(n_single)
            if not (pad_fused and axes[i] == ndim - 1)]
    j = 0
    while j + 1 < len(cand):
        i1, i2 = cand[j], cand[j + 1]
        if (axes[i2] == axes[i1] + 1 and axes[i2] == ndim - 2
                and _execute.mid_pair_ok(lengths[i1], lengths[i2],
                                         tgt[-1], ar.dtype, cfg)):
            mid_second[i1] = i2
            j += 2
        else:
            j += 1
    skip = set(mid_second.values())
    last_fused = cube_last or pair_last
    for k, i in enumerate(order):
        if i in skip:
            continue
        takes_scale = not last_fused and k == n_single - 1
        axis_scale = scale if takes_scale else 1.0
        if i in mid_second:
            takes_scale = (not last_fused
                           and max(i, mid_second[i]) == order[-1])
            ar, ai = _execute.fft_mid_pair(
                ar, ai, axes[i], inverse=plan.inverse,
                scale=scale if takes_scale else 1.0)
        elif pad_fused and axes[i] == ndim - 1:
            ar, ai = _execute.fft_axis_padded(
                ar, ai, axes[i], lengths[i], inverse=plan.inverse,
                scale=axis_scale, config=cfg)
        elif lengths[i] == 1 and axis_scale == 1.0:
            continue
        else:
            ar, ai = _execute.fft_axis(
                ar, ai, axes[i], plan.bases[i], inverse=plan.inverse,
                scale=axis_scale, config=cfg,
            )
    if cube_last:
        ar, ai = _execute.fft_cube_last(ar, ai, inverse=plan.inverse,
                                        scale=scale)
    elif pair_last and pair_pad is None:
        ar, ai = _execute.fft_pair_last(ar, ai, inverse=plan.inverse,
                                        scale=scale)
    if ai is None:
        ai = torch.zeros_like(ar)
    return ar, ai


def _apply_r2c(ar, plan: Plan, scale: float):
    """rfft over the plan's axes of the real plane ``ar``: crop/pad every
    axis, transform the last axis real to half spectrum, then a forward C2C
    over the other axes on the n//2+1-packed planes; the whole scale goes
    on the last pass (tpufft's ``_apply_r2c``). The last axis runs on K7
    where its envelope holds, else the packed half-length path (even n) or
    a full C2C and a slice (odd n)."""
    axes, lengths = plan.axes, plan.lengths
    for a, n in zip(axes, lengths):
        ar = _resize_axis(ar, n, a)
    n_last = lengths[-1]
    s_last = scale if len(axes) == 1 else 1.0
    if n_last >= 2 and _execute.r2c_minor_supported(n_last, ar.dtype,
                                                    plan.config):
        ar, ai = _execute.rfft_minor(ar, axes[-1], n_last, s_last,
                                     plan.config)
    elif n_last % 2 == 0 and n_last >= 2:
        ar, ai = _rfft_packed_last(ar, axes[-1], n_last, s_last, plan.config)
    else:
        ar, ai = _execute.fft_axis(
            ar, None, axes[-1], plan.bases[-1], inverse=False, scale=s_last,
            config=plan.config,
        )
        ar = ar.narrow(axes[-1], 0, n_last // 2 + 1)
        ai = ai.narrow(axes[-1], 0, n_last // 2 + 1)
    for i, a in enumerate(axes[:-1]):
        axis_scale = scale if i == len(axes) - 2 else 1.0
        ar, ai = _execute.fft_axis(
            ar, ai, a, plan.bases[i], inverse=False, scale=axis_scale,
            config=plan.config,
        )
    return ar, ai


def _apply_c2r(ar, ai, plan: Plan, scale: float):
    """irfft over the plan's axes (tpufft's ``_apply_c2r``): an inverse C2C
    over the leading axes on the packed planes, then the last axis half
    spectrum to real, on K8 where its envelope holds, else the packed
    half-length inverse (even n) or the Hermitian extension and an inverse
    C2C over every axis (odd n). Returns (real plane, None)."""
    axes, lengths = plan.axes, plan.lengths
    n_last = lengths[-1]
    for a, n in zip(axes[:-1], lengths[:-1]):
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    if ai is None:
        ai = torch.zeros_like(ar)
    kernel = n_last >= 2 and _execute.r2c_minor_supported(
        n_last, ar.dtype, plan.config)
    if kernel or (n_last % 2 == 0 and n_last >= 2):
        m1 = n_last // 2 + 1
        ar = _resize_axis(ar, m1, axes[-1])
        ai = _resize_axis(ai, m1, axes[-1])
        for i, a in enumerate(axes[:-1]):
            ar, ai = _execute.fft_axis(
                ar, ai, a, plan.bases[i], inverse=True, scale=1.0,
                config=plan.config,
            )
        if kernel:
            return _execute.irfft_minor(ar, ai, axes[-1], n_last, scale,
                                        plan.config), None
        return _irfft_packed_last(ar, ai, axes[-1], n_last, 2.0 * scale,
                                  plan.config), None
    ar, ai = _hermitian_extend(ar, ai, n_last, axes[-1],
                               other_axes=axes[:-1])
    for i, a in enumerate(axes):
        axis_scale = scale if i == len(axes) - 1 else 1.0
        ar, ai = _execute.fft_axis(
            ar, ai, a, plan.bases[i], inverse=True, scale=axis_scale,
            config=plan.config,
        )
    return ar, None


@functools.lru_cache(maxsize=64)
def _half_twiddle(m: int, n: int):
    """Host W[k] = exp(-2 pi i k / n) for k in [0, m], float64 planes."""
    k = np.arange(m + 1, dtype=np.float64)
    theta = -2.0 * np.pi * k / n
    return np.cos(theta), np.sin(theta)


def _half_twiddle_planes(m: int, n: int, like: torch.Tensor):
    return tuple(torch.as_tensor(w, dtype=like.dtype, device=like.device)
                 for w in _half_twiddle(m, n))


def _rfft_packed_last(ar, axis: int, n: int, scale: float,
                      config: PlanConfig):
    """Half-length packed rfft along ``axis`` (n even, real plane): the n
    reals as n/2 complex points (even samples real, odd imaginary), one
    length-n/2 C2C through the axis ladder, and the Hermitian untangle in
    torch ops (tpufft's ``_rfft_packed_last``)."""
    m = n // 2
    ar = ar.movedim(axis, -1)
    pre = ar.shape[:-1]
    x2 = ar.reshape(pre + (m, 2))
    zr, zi = _execute.fft_axis(
        x2[..., 0], x2[..., 1], ar.ndim - 1, default_bases(m),
        inverse=False, scale=scale, config=config,
    )
    # k-indexed (length m+1) views: Z[k % m] and Z[(m - k) % m]
    zk_r = torch.cat([zr, zr[..., :1]], -1)
    zk_i = torch.cat([zi, zi[..., :1]], -1)
    zj_r = torch.cat([zr[..., :1], zr[..., 1:].flip(-1), zr[..., :1]], -1)
    zj_i = torch.cat([zi[..., :1], zi[..., 1:].flip(-1), zi[..., :1]], -1)
    # Xe = (Z + conj(Zj))/2 ; Xo = -i (Z - conj(Zj))/2
    ae = (zk_r + zj_r) * 0.5
    be = (zk_i - zj_i) * 0.5
    ao = (zk_i + zj_i) * 0.5
    bo = (zj_r - zk_r) * 0.5
    wr, wi = _half_twiddle_planes(m, n, zr)
    xr = ae + wr * ao - wi * bo
    xi = be + wr * bo + wi * ao
    return xr.movedim(-1, axis), xi.movedim(-1, axis)


def _irfft_packed_last(ar, ai, axis: int, n: int, inner_scale: float,
                       config: PlanConfig):
    """Half-length packed irfft along ``axis`` (n even) of the n//2+1
    packed planes; ``inner_scale`` is twice the caller's scale. Returns the
    real plane (tpufft's ``_irfft_packed_last``)."""
    m = n // 2
    ar = ar.movedim(axis, -1)
    ai = ai.movedim(axis, -1)
    pre = ar.shape[:-1]
    # the imaginary parts of the DC and Nyquist bins are inert (numpy's
    # irfft); zeroing them makes the packed spectrum exactly Hermitian
    zero = torch.zeros_like(ai[..., :1])
    ai = torch.cat([zero, ai[..., 1:m], zero], -1)
    # Xc[k] = conj(X[m-k]) for k in [0, m)
    xc_r = ar[..., 1:].flip(-1)
    xc_i = -ai[..., 1:].flip(-1)
    xr, xi = ar[..., :m], ai[..., :m]
    # Xe = (X + Xc)/2 ; (W Xo) = (X - Xc)/2 ; Xo = conj(W) * (W Xo)
    er = (xr + xc_r) * 0.5
    ei = (xi + xc_i) * 0.5
    ur = (xr - xc_r) * 0.5
    ui = (xi - xc_i) * 0.5
    wr, wi = _half_twiddle_planes(m - 1, n, ar)
    or_ = wr * ur + wi * ui
    oi = wr * ui - wi * ur
    zr, zi = _execute.fft_axis(
        er - oi, ei + or_, ar.ndim - 1, default_bases(m), inverse=True,
        scale=inner_scale, config=config,
    )
    out = torch.stack([zr, zi], -1).reshape(pre + (n,))
    return out.movedim(-1, axis)


def _hermitian_extend(ar, ai, n: int, axis: int, other_axes):
    """The full length-n spectrum from the n//2+1 Hermitian-packed bins:
    the mirrored half conjugated and index-negated along every other
    transformed axis (tpufft's ``_hermitian_extend``)."""
    if ai is None:
        ai = torch.zeros_like(ar)
    expected = n // 2 + 1
    if ar.shape[axis] != expected:
        ar = _resize_axis(ar, expected, axis)
        ai = _resize_axis(ai, expected, axis)
    mir_r = ar.narrow(axis, 1, (n + 1) // 2 - 1).flip(axis)
    mir_i = -ai.narrow(axis, 1, (n + 1) // 2 - 1).flip(axis)
    for a in other_axes:
        # index negation mod n_a: k -> (-k) % n_a == roll(flip, 1)
        mir_r = torch.roll(mir_r.flip(a), 1, dims=a)
        mir_i = torch.roll(mir_i.flip(a), 1, dims=a)
    return (torch.cat([ar, mir_r], dim=axis),
            torch.cat([ai, mir_i], dim=axis))


def _check_ported(kind: str, layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(
            "layout must be 'natural', 'transform-major' or 'lane-fused', "
            f"got {layout!r}")
    if layout != "natural":
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 3: api.py layouts)")
    if kind not in ("c2c", "r2c", "c2r"):
        raise ValueError(f"kind must be 'c2c', 'r2c' or 'c2r', got {kind!r}")


def plan_fft(
    shape: Sequence[int],
    dtype=torch.complex64,
    *,
    axes=None,
    s: Sequence[int] | None = None,
    inverse: bool = False,
    norm: str | None = None,
    kind: str = "c2c",
    bases=None,
    config: PlanConfig | None = None,
    layout: str = "natural",
    device=None,
) -> Plan:
    """Build an FFT plan (the arguments of ``tpufft.plan_fft``, plus the
    ``device`` that numpy input is moved to: None for the CUDA device)."""
    cfg = config or PlanConfig()
    shape = tuple(int(d) for d in shape)
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    axes = _axes_from_s(s, axes)
    axes = _canon_axes(len(shape), axes)
    if isinstance(s, str):
        s = (s,) * len(axes)
    _check_ported(kind, layout)
    if s is None:
        lengths = tuple(shape[a] for a in axes)
        if kind == "c2r":
            lengths = lengths[:-1] + (2 * (shape[axes[-1]] - 1),)
    else:
        if len(s) != len(axes):
            raise ValueError(f"len(s)={len(s)} must equal len(axes)={len(axes)}")
        lengths = tuple(
            _resolve_fast_length(v, shape[a]) for v, a in zip(s, axes)
        )
    bases = _resolve_bases(lengths, bases, cfg)
    return Plan(
        shape=shape, dtype=dtype_name(dtype), axes=axes, lengths=lengths,
        bases=bases, inverse=bool(inverse), norm=norm, kind=kind, config=cfg,
        device=None if device is None else str(torch.device(device)),
    )


def _logical_dtype(x):
    """The plan dtype for an input: its own dtype, or c64/c128 for planes."""
    if isinstance(x, SplitComplex):
        return (torch.complex128 if x.dtype == torch.float64
                else torch.complex64)
    if isinstance(x, torch.Tensor):
        return x.dtype
    return np.asarray(x).dtype


def _shape_of(x) -> tuple[int, ...]:
    if isinstance(x, (SplitComplex, torch.Tensor)):
        return tuple(x.shape)
    return tuple(np.shape(x))


def _plan_for(x, axes, s, inverse, norm, kind, bases, config, device):
    return plan_fft(
        _shape_of(x), _logical_dtype(x), axes=axes, s=s, inverse=inverse,
        norm=norm, kind=kind, bases=bases, config=config, device=device,
    )


def fft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
        device=None):
    """1-D complex FFT (real input allowed; full spectrum out)."""
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, False, norm, "c2c", bases, config,
                     device)(x)


def ifft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
         device=None):
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, True, norm, "c2c", bases, config,
                     device)(x)


def rfft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
         device=None):
    """1-D FFT of real input: the n//2+1 bins of the half spectrum."""
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, False, norm, "r2c", bases, config,
                     device)(x)


def irfft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
          device=None):
    """Inverse of rfft: real output of length n (default 2 (m - 1))."""
    if n is None:
        n = 2 * (_shape_of(x)[axis] - 1)
    return _plan_for(x, (axis,), (n,), True, norm, "c2r", bases, config,
                     device)(x)


def fftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
         device=None):
    return _plan_for(x, axes, s, False, norm, "c2c", bases, config,
                     device)(x)


def ifftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
          device=None):
    return _plan_for(x, axes, s, True, norm, "c2c", bases, config,
                     device)(x)


def rfftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
          device=None):
    return _plan_for(x, axes, s, False, norm, "r2c", bases, config,
                     device)(x)


def irfftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
           device=None):
    shape = _shape_of(x)
    axes_c = _canon_axes(len(shape), _axes_from_s(s, axes))
    if s is None:
        s = tuple(shape[a] for a in axes_c[:-1]) + (
            2 * (shape[axes_c[-1]] - 1),)
    return _plan_for(x, axes_c, s, True, norm, "c2r", bases, config,
                     device)(x)


def fft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return fftn(x, s=s, axes=axes, norm=norm, **kw)


def ifft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return ifftn(x, s=s, axes=axes, norm=norm, **kw)


def rfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return rfftn(x, s=s, axes=axes, norm=norm, **kw)


def irfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return irfftn(x, s=s, axes=axes, norm=norm, **kw)


# ----------------------------------------------------------------------------
# The Hermitian family: thin wrappers over rfft and irfft
# ----------------------------------------------------------------------------

def _conj_any(x):
    if isinstance(x, SplitComplex):
        return x.conj()
    if isinstance(x, torch.Tensor):
        return x.conj().resolve_conj() if x.is_complex() else x
    return np.conj(np.asarray(x))


def _rescale(res, scale: float):
    """res times a real scale, in res's own form and dtype."""
    if isinstance(res, SplitComplex):
        return SplitComplex(res.re * scale, res.im * scale)
    if isinstance(res, np.ndarray):
        return res * np.asarray(scale, res.dtype)
    return res * scale


def _check_norm(norm) -> None:
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")


def hfft(x, n=None, axis=-1, norm=None, **kw):
    """FFT of Hermitian-symmetric input (real spectrum out):
    hfft(x, n) == irfft(conj(x), n) * n under the backward norm."""
    _check_norm(norm)
    if n is None:
        n = 2 * (_shape_of(x)[axis] - 1)
    res = irfft(_conj_any(x), n=n, axis=axis, norm=None, **kw)
    scale = {None: float(n), "backward": float(n),
             "ortho": math.sqrt(n), "forward": 1.0}[norm]
    return _rescale(res, scale)


def ihfft(x, n=None, axis=-1, norm=None, **kw):
    """Inverse of hfft: real input, the conjugate half spectrum out."""
    _check_norm(norm)
    if n is None:
        n = _shape_of(x)[axis]
    res = rfft(x, n=n, axis=axis, norm=None, **kw)
    scale = {None: 1.0 / n, "backward": 1.0 / n,
             "ortho": 1.0 / math.sqrt(n), "forward": 1.0}[norm]
    return _rescale(_conj_any(res), scale)


def _hfft_scale(res, n_total: int, norm, inverse: bool):
    """The hfft/ihfft norm rescale over the product of the transformed
    lengths (scipy's convention for the Hermitian family)."""
    if inverse:
        scale = {None: 1.0 / n_total, "backward": 1.0 / n_total,
                 "ortho": 1.0 / math.sqrt(n_total), "forward": 1.0}[norm]
    else:
        scale = {None: float(n_total), "backward": float(n_total),
                 "ortho": math.sqrt(n_total), "forward": 1.0}[norm]
    return _rescale(res, scale)


def hfftn(x, s=None, axes=None, norm=None, **kw):
    """ND FFT of an array Hermitian-symmetric in its last transformed axis
    (real spectrum out): irfftn(conj(x), s, axes) * N under the backward
    norm, N the product of the output's transformed lengths."""
    _check_norm(norm)
    res = irfftn(_conj_any(x), s=s, axes=axes, norm=None, **kw)
    shape = _shape_of(res)
    ax = _canon_axes(len(shape), _axes_from_s(s, axes))
    n_total = math.prod(shape[a] for a in ax)
    return _hfft_scale(res, n_total, norm, inverse=False)


def hfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return hfftn(x, s=s, axes=axes, norm=norm, **kw)


def ihfftn(x, s=None, axes=None, norm=None, **kw):
    """Inverse of hfftn: real input, the conjugate half spectrum out."""
    _check_norm(norm)
    in_shape = _shape_of(x)
    ax = _canon_axes(len(in_shape), _axes_from_s(s, axes))
    # the norm counts the transform lengths (s or the input's), not the
    # packed n//2+1 of the output
    if s is not None:
        s_seq = (s,) * len(ax) if isinstance(s, str) else s
        lengths = tuple(_resolve_fast_length(v, in_shape[a])
                        for v, a in zip(s_seq, ax))
    else:
        lengths = tuple(in_shape[a] for a in ax)
    res = _conj_any(rfftn(x, s=s, axes=axes, norm=None, **kw))
    return _hfft_scale(res, math.prod(lengths), norm, inverse=True)


def ihfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return ihfftn(x, s=s, axes=axes, norm=norm, **kw)


# ----------------------------------------------------------------------------
# Host helpers (numpy semantics)
# ----------------------------------------------------------------------------

def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def fftfreq(n, d=1.0, *, dtype=None, device=None) -> torch.Tensor:
    """The sample frequencies of an n-point DFT with sample spacing d
    (``np.fft.fftfreq``), float32 unless ``dtype`` says otherwise, on
    ``device`` (None: the CUDA device, as for numpy input)."""
    n = int(n)
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1),
                   torch.arange(-(n // 2), 0)])
    out = k.to(torch.float64) / (n * d)
    return out.to(numpy_device(device), _torch_dtype(dtype))


def rfftfreq(n, d=1.0, *, dtype=None, device=None) -> torch.Tensor:
    """The n//2 + 1 non-negative sample frequencies of an n-point real DFT
    (``np.fft.rfftfreq``); dtype and device as for :func:`fftfreq`."""
    n = int(n)
    out = torch.arange(0, n // 2 + 1, dtype=torch.float64) / (n * d)
    return out.to(numpy_device(device), _torch_dtype(dtype))


def _shift(x, axes, sign):
    if isinstance(x, SplitComplex):
        return SplitComplex(_shift(x.re, axes, sign), _shift(x.im, axes, sign))
    tensor = isinstance(x, torch.Tensor)
    if not tensor:
        x = np.asarray(x)   # numpy in -> numpy out
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(axes)
    shifts = [sign * (x.shape[a] // 2) for a in axes]
    return (torch.roll(x, shifts, axes) if tensor
            else np.roll(x, shifts, axes))


def fftshift(x, axes=None):
    """Move the zero-frequency term to the centre along ``axes`` (all by
    default); tensors, ``SplitComplex`` planes and numpy arrays keep their
    form and device."""
    return _shift(x, axes, 1)


def ifftshift(x, axes=None):
    """The inverse of :func:`fftshift`."""
    return _shift(x, axes, -1)
