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

The surface is tpufft's: c2c, r2c and c2r plans over any set of axes,
the four norms, ``n``/``s`` crop and zero-pad (including
"fast"/"fast-aligned"), explicit ``bases``, ``PlanConfig`` and autograd;
rfft/irfft/rfftn/irfftn/rfft2/irfft2 and the hfft family, and the host
helpers ``fftfreq``, ``rfftfreq``, ``fftshift``, ``ifftshift``. When a
plan's last three axes are the array's three minor axes and the cube fits
the cube kernel, they run in one pass (tpufft's ``cube_last`` rule); else
when its last two are the two minor axes and fit the pair kernel, they do
(``pair_last``); two adjacent middle axes in front of the minor one run in
one mid-pair pass; a zero-padded minor axis pads inside its kernel's load
(tpufft's ``pad_fused`` and ``pair_pad`` rules). Each fusion follows the
port's own kernel envelopes, so a shape tpufft fuses may run in more
passes here, with the same result.

c2c plans also take tpufft's two other layouts (``plan_fft(layout=...)``),
converted at the pipeline's edges by ``Plan.pack`` and ``Plan.unpack``:

* ``"transform-major"``: the planes are stored with the transform axes
  permuted (one axis: moved first; several: tpufft's lane-utilization
  order, kept verbatim though it is a TPU rule) and run the natural
  pipeline on that physical shape;
* ``"lane-fused"``: the data is ONE real array (..., n1, n2, 2*n3) whose
  minor logical rows hold [re | im]; the plan runs tpufft's tiers on the
  fused kernels (``kernels/fused_fft``, K16-K20): the trailing cube, else
  the trailing pair, else every axis on its own, the leading axes first;
  when no tier fits, the split-plane pipeline on the two halves.

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
from .kernels import fused_fft as _fused
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


_COMPUTE_DTYPES = (torch.float32, torch.float64, torch.complex64,
                   torch.complex128)


def compute_tensor(x, device=None) -> tuple[torch.Tensor, bool]:
    """``x`` as the tensor a filtering layer computes on, and whether it
    came as numpy. A tensor stays where it lies, numpy goes to
    ``numpy_device(device)``; float32, float64, complex64 and complex128
    keep their dtype, other real (complex) dtypes compute in float64
    (complex128) for numpy and float32 (complex64) for tensors."""
    if isinstance(x, torch.Tensor):
        if x.dtype in _COMPUTE_DTYPES:
            return x, False
        return x.to(torch.complex64 if x.is_complex() else torch.float32), \
            False
    xn = np.asarray(x)
    if xn.dtype not in (np.float32, np.float64, np.complex64,
                        np.complex128):
        xn = xn.astype(np.complex128 if np.iscomplexobj(xn) else np.float64)
    return torch.from_numpy(np.ascontiguousarray(xn)).to(
        numpy_device(device)), True


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

    A ``layout="transform-major"`` plan's ``shape`` and ``axes`` describe
    the PHYSICAL planes; ``logical_shape`` is the user's view, and
    ``logical_axis`` (one axis) or ``logical_perm`` (several; physical dim
    i is logical dim ``logical_perm[i]``) maps one to the other. A
    ``layout="lane-fused"`` plan's ``shape`` is the logical shape; it runs
    on the fused (..., 2 * shape[-1]) array.
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
    layout: str = "natural"
    logical_shape: tuple[int, ...] | None = None
    logical_axis: int | None = None
    logical_perm: tuple[int, ...] | None = None

    def __call__(self, x):
        """Execute the plan; the output form follows the input form, and a
        c2r plan returns its real plane. A lane-fused plan takes and returns
        the fused real array (a tensor; numpy input moves to the plan's
        device first)."""
        if self.layout == "lane-fused":
            st = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(np.asarray(x))).to(
                    numpy_device(self.device))
            expect = self.shape[:-1] + (2 * self.shape[-1],)
            if tuple(st.shape) != expect:
                raise ValueError(
                    f"lane-fused plan expects fused shape {expect} "
                    f"(lanes [re|im]), got {tuple(st.shape)}; use "
                    "Plan.pack() to convert")
            return _apply_plan_fused(st.to(self._plane_dtype()), plan=self)
        split_io = isinstance(x, SplitComplex)
        numpy_io = not split_io and not isinstance(x, torch.Tensor)
        ar, ai = self._split_input(x)
        rdt = self._plane_dtype()
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

    def _plane_dtype(self) -> torch.dtype:
        """float64 for c128 plans; bfloat16 for f32 planes under
        ``plane_dtype="bfloat16"``; else float32."""
        rdt = real_dtype_for(self.dtype)
        if self.config.plane_dtype == "bfloat16" and rdt == torch.float32:
            rdt = torch.bfloat16
        return rdt

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

    # -- layout conversion ---------------------------------------------------
    # The conversion is the repack a layout exists to avoid: pack once at a
    # pipeline's entry (on the host when the data starts there), keep the
    # data in the plan's layout across calls, unpack once at its exit.

    def _perm(self) -> tuple[int, ...]:
        """A transform-major plan's physical dim i is logical dim
        ``_perm()[i]``."""
        if self.logical_perm is not None:
            return self.logical_perm
        ax = self.logical_axis
        return (ax,) + tuple(i for i in range(len(self.shape)) if i != ax)

    def pack(self, x):
        """Convert a LOGICAL-layout array to this plan's physical layout.

        Host numpy input converts on the host, then moves to the plan's
        device; tensors and ``SplitComplex`` planes convert where they lie.
        transform-major -> ``SplitComplex`` planes in the physical order;
        lane-fused -> ONE real tensor (..., n1, n2, 2*n3), lanes [re|im];
        natural -> ``SplitComplex`` planes. Host complex128 or float64 packs
        to float64, anything else to float32."""
        if self.layout == "lane-fused":
            if isinstance(x, SplitComplex):
                return torch.cat([x.re, x.im], dim=-1)
            if isinstance(x, torch.Tensor):
                re, im = _tensor_planes(x)
                return torch.cat([re, im], dim=-1)
            re, im = _host_planes(x)
            return torch.from_numpy(np.concatenate([re, im], axis=-1)).to(
                numpy_device(self.device))
        if self.layout != "transform-major":
            return _as_split(x, self.device)
        perm = self._perm()
        if isinstance(x, (SplitComplex, torch.Tensor)):
            re, im = x if isinstance(x, SplitComplex) else _tensor_planes(x)
            return SplitComplex(re.permute(perm).contiguous(),
                                im.permute(perm).contiguous())
        dev = numpy_device(self.device)
        return SplitComplex(*(
            torch.from_numpy(np.ascontiguousarray(p.transpose(perm))).to(dev)
            for p in _host_planes(x)))

    def unpack(self, y):
        """Convert a plan-layout result back to the LOGICAL layout.

        transform-major: ``SplitComplex`` in -> ``SplitComplex`` out, a
        tensor in -> a tensor out (one permuting copy where they lie); numpy
        otherwise. lane-fused: the fused tensor -> ``SplitComplex`` (two
        lane slices, bf16 widened to float32); numpy -> numpy complex.
        natural: ``y`` itself."""
        if self.layout == "lane-fused":
            n3 = self.lengths[-1]
            if isinstance(y, torch.Tensor):
                re, im = y[..., :n3], y[..., n3:]
                if re.dtype == torch.bfloat16:
                    re, im = re.float(), im.float()
                return SplitComplex(re, im)
            yn = np.asarray(y)
            return yn[..., :n3] + 1j * yn[..., n3:]
        if self.layout != "transform-major":
            return y
        inv = tuple(int(i) for i in np.argsort(self._perm()))
        if isinstance(y, SplitComplex):
            return SplitComplex(y.re.permute(inv).contiguous(),
                                y.im.permute(inv).contiguous())
        if isinstance(y, torch.Tensor):
            return y.permute(inv).contiguous()
        return np.ascontiguousarray(np.transpose(np.asarray(y), inv))


def _tensor_planes(x: torch.Tensor):
    """A tensor's real and imaginary planes (zeros for a real tensor)."""
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def _host_planes(x):
    """The real and imaginary planes of a host array-like as numpy arrays:
    float64 for complex128/float64 input, float32 otherwise; a real input's
    imaginary plane is zeros."""
    xn = np.asarray(x)
    rdt = np.float64 if xn.dtype in (np.complex128, np.float64) else np.float32
    re = np.asarray(xn.real, rdt)
    im = (np.asarray(xn.imag, rdt) if np.iscomplexobj(xn)
          else np.zeros_like(re))
    return re, im


def _as_split(x, device) -> SplitComplex:
    """``SplitComplex`` planes of any input form (tpufft's
    ``SplitComplex.from_array``): planes as they are, a tensor's parts where
    it lies, numpy on ``numpy_device(device)``."""
    if isinstance(x, SplitComplex):
        return x
    if isinstance(x, torch.Tensor):
        return SplitComplex(*_tensor_planes(x))
    dev = numpy_device(device)
    return SplitComplex(*(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                          for p in _host_planes(x)))


def _apply_plan_fused(st, *, plan: Plan):
    """Transform the lane-fused array ``st`` (tpufft's
    ``_apply_plan_fused``), with tpufft's tiers in its order:

    1. the trailing cube in one K16 pass;
    2. else the trailing pair in one K17 pass;
    3. else the minor axis in one K20 pass;

    each tier's leading axes first, one K18 pass each (K19 for the axis
    next to the minor one), with scale 1, and the whole norm folded into
    the tier's last pass. A tier runs when its kernels' gates hold
    (``kernels/fused_fft``: the port's envelopes on the logical lengths)
    and the backend is not "xla". When no tier fits (float64,
    ``backend="xla"``, lengths outside the envelopes), the split-plane
    pipeline runs on the two halves, which are then concatenated: tpufft's
    own last route, still on the split-plane kernels for f32/bf16."""
    lengths, axes = plan.lengths, plan.axes
    n3 = lengths[-1]
    scale = _norm_scale(plan.norm, math.prod(lengths), plan.inverse)
    kernel_ok = plan.config.backend != "xla"
    dt, inv = st.dtype, plan.inverse

    def leading_ok(k: int) -> bool:
        return all(_fused.inner_supported(n, dt) for n in lengths[:k])

    def leading(st, k: int):
        for a in axes[:k]:
            st = _execute.fft_axis_fused(st, a, inverse=inv, scale=1.0)
        return st

    if (kernel_ok and _fused.cube_supported(*lengths[-3:], dt)
            and leading_ok(len(axes) - 3)):
        return _execute.fft_cube_fused(leading(st, len(axes) - 3),
                                       inverse=inv, scale=scale)
    if (kernel_ok and _fused.pair_supported(lengths[-2], n3, dt)
            and leading_ok(len(axes) - 2)):
        return _execute.fft_pair_fused(leading(st, len(axes) - 2),
                                       inverse=inv, scale=scale)
    if (kernel_ok and _fused.minor_supported(n3, dt)
            and leading_ok(len(axes) - 1)):
        return _execute.fft_minor_fused(leading(st, len(axes) - 1),
                                        inverse=inv, scale=scale)
    outr, outi = _apply_plan_split(st[..., :n3], st[..., n3:], plan=plan)
    return torch.cat([outr, outi], dim=-1)


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


def _check_kind_layout(kind: str, layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(
            "layout must be 'natural', 'transform-major' or 'lane-fused', "
            f"got {layout!r}")
    if kind not in ("c2c", "r2c", "c2r"):
        raise ValueError(f"kind must be 'c2c', 'r2c' or 'c2r', got {kind!r}")


def _lane_util(n: int) -> float:
    """tpufft's lane utilization of a length stored on the TPU's 128-lane
    minor dim, n / (ceil(n/128) * 128). A TPU rule, kept verbatim: it
    orders a transform-major plan's axes, and ``Plan.shape`` and
    ``logical_perm`` are public."""
    return n / (-(-n // 128) * 128)


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
    ``device`` that numpy input is moved to: None for the CUDA device).

    ``layout="transform-major"`` (c2c only): the plan's planes store the
    transform axes permuted. One axis goes first, ``moveaxis(x, axis, 0)``
    (``s`` allowed); several are ordered by tpufft's lane rule
    (:func:`_lane_util`, ascending) behind the other dims, so the most
    lane-aligned length is minor (no ``s``). ``layout="lane-fused"``: a c2c
    plan over at least three axes, the last three among them, without
    ``s``; its axes are sorted. Convert with :meth:`Plan.pack` and
    :meth:`Plan.unpack` at the pipeline's edges."""
    cfg = config or PlanConfig()
    shape = tuple(int(d) for d in shape)
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    axes = _axes_from_s(s, axes)
    axes = _canon_axes(len(shape), axes)
    if isinstance(s, str):
        s = (s,) * len(axes)
    _check_kind_layout(kind, layout)
    dev = None if device is None else str(torch.device(device))
    if layout != "natural":
        return _layout_plan(shape, dtype, axes, s, inverse, norm, kind, bases,
                            cfg, layout, dev)
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
        device=dev,
    )


def _layout_plan(shape, dtype, axes, s, inverse, norm, kind, bases, cfg,
                 layout, device) -> Plan:
    """A transform-major or lane-fused plan (tpufft's layout branch of
    ``plan_fft``, with its errors)."""
    common = dict(dtype=dtype_name(dtype), inverse=bool(inverse), norm=norm,
                  kind=kind, config=cfg, device=device, layout=layout,
                  logical_shape=shape)
    if layout == "lane-fused":
        if kind != "c2c" or len(axes) < 3 or s is not None:
            raise ValueError(
                "layout='lane-fused' supports >=3-axis c2c plans without "
                "resize (s)")
        if not {len(shape) - 3, len(shape) - 2, len(shape) - 1} <= set(axes):
            raise ValueError(
                "layout='lane-fused' requires the transform axes to "
                f"include the last three, got {axes}")
        # a multi-axis c2c transform is order-independent; the fused body
        # peels the leading axes and takes the last three as its tier
        axes = tuple(sorted(axes))
        lengths = tuple(shape[a] for a in axes)
        return Plan(shape=shape, axes=axes, lengths=lengths,
                    bases=_resolve_bases(lengths, bases, cfg), **common)
    if kind != "c2c":
        raise ValueError("layout='transform-major' supports c2c plans")
    if len(axes) == 1:
        ax = axes[0]
        phys = (shape[ax],) + tuple(d for i, d in enumerate(shape) if i != ax)
        n = shape[ax] if s is None else _resolve_fast_length(s[0], shape[ax])
        return Plan(shape=phys, axes=(0,), lengths=(n,),
                    bases=_resolve_bases((n,), bases, cfg), logical_axis=ax,
                    **common)
    if s is not None:
        raise ValueError(
            "layout='transform-major' with multiple axes does not support "
            "resize (s)")
    # the other dims keep their order in front, then the transform axes,
    # the most lane-aligned last (a separable transform runs in any order)
    batch = tuple(i for i in range(len(shape)) if i not in axes)
    order = sorted(axes, key=lambda a: (_lane_util(shape[a]), shape[a]))
    perm = batch + tuple(order)
    phys = tuple(shape[p] for p in perm)
    phys_axes = tuple(range(len(shape) - len(axes), len(shape)))
    lengths = tuple(phys[a] for a in phys_axes)
    return Plan(shape=phys, axes=phys_axes, lengths=lengths,
                bases=_resolve_bases(lengths, bases, cfg), logical_perm=perm,
                **common)


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
