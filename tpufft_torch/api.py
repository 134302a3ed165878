"""Public API: plans and the complex FFT functions (counterpart of
``tpufft/api.py``).

Complex data crosses this boundary in three forms, and the output form
follows the input form:

* a torch tensor (complex or real) -> a complex tensor on the same device;
* ``SplitComplex(re, im)`` planes -> ``SplitComplex`` planes;
* a numpy array -> a numpy complex array, computed on the plan's
  ``device`` (``"cpu"`` unless the caller names one).

Tensors run where they lie; nothing picks a device on its own.

Ported so far: complex-to-complex plans over any set of axes, the four
norms, ``n``/``s`` crop and zero-pad (including "fast"/"fast-aligned"),
explicit ``bases``, ``PlanConfig`` and autograd. When a plan's last two
axes are the array's two minor axes and the pair fits the pair kernel,
they run in one pass (tpufft's ``pair_last`` rule). Real transforms and
the transform-major / lane-fused layouts raise NotImplementedError;
tpufft's cube, mid-pair and pad fusions are not ported (the results are
the same, in more passes).
"""

from __future__ import annotations

import dataclasses
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
    "SplitComplex",
    "plan_fft",
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
]

_NORMS = (None, "backward", "ortho", "forward")
_LAYOUTS = ("natural", "transform-major", "lane-fused")


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
    normalization, configuration, and the device numpy input is moved to.
    """

    shape: tuple[int, ...]
    dtype: str
    axes: tuple[int, ...]
    lengths: tuple[int, ...]           # transform length per axis (after resize)
    bases: tuple[tuple[int, ...], ...]
    inverse: bool
    norm: str | None
    kind: str                          # "c2c"
    config: PlanConfig
    device: str = "cpu"

    def __call__(self, x):
        """Execute the plan; the output form follows the input form."""
        split_io = isinstance(x, SplitComplex)
        numpy_io = not split_io and not isinstance(x, torch.Tensor)
        ar, ai = self._split_input(x)
        rdt = real_dtype_for(self.dtype)
        if self.config.plane_dtype == "bfloat16" and rdt == torch.float32:
            rdt = torch.bfloat16
        ar = ar.to(rdt)
        ai = None if ai is None else ai.to(rdt)
        outr, outi = _apply_plan_split(ar, ai, plan=self)
        out = SplitComplex(outr, outi)
        if split_io:
            return out
        if numpy_io:
            return out.numpy()
        return out.complex()

    def _split_input(self, x):
        if isinstance(x, SplitComplex):
            ar, ai = x.re, x.im
        elif isinstance(x, tuple):
            raise TypeError(
                "pass plane pairs as SplitComplex(re, im), not a bare tuple"
            )
        elif isinstance(x, torch.Tensor):
            ar, ai = (x.real, x.imag) if x.is_complex() else (x, None)
        else:
            xn = np.asarray(x)

            def host(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            if np.iscomplexobj(xn):
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
        return tuple(shape)


def _apply_plan_split(ar, ai, *, plan: Plan):
    """Crop/pad every axis, then transform: the trailing pair in one pass
    when it fits the pair kernel, every other axis in order. The whole
    normalization is folded into the last pass (the pair's when it runs)."""
    axes, lengths = plan.axes, plan.lengths
    scale = _norm_scale(plan.norm, math.prod(lengths), plan.inverse)
    for a, n in zip(axes, lengths):
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    ndim = ar.ndim
    pair_last = (
        len(axes) >= 2
        and set(axes[-2:]) == {ndim - 2, ndim - 1}
        and _execute.pair_supported(ar.shape[-2], ar.shape[-1], ar.dtype,
                                    plan.config)
    )
    n_single = len(axes) - (2 if pair_last else 0)
    for k in range(n_single):
        takes_scale = not pair_last and k == n_single - 1
        ar, ai = _execute.fft_axis(
            ar, ai, axes[k], plan.bases[k], inverse=plan.inverse,
            scale=scale if takes_scale else 1.0, config=plan.config,
        )
    if pair_last:
        ar, ai = _execute.fft_pair_last(ar, ai, inverse=plan.inverse,
                                        scale=scale)
    if ai is None:
        ai = torch.zeros_like(ar)
    return ar, ai


def _check_ported(kind: str, layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(
            "layout must be 'natural', 'transform-major' or 'lane-fused', "
            f"got {layout!r}")
    if layout != "natural":
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 3: api.py layouts)")
    if kind in ("r2c", "c2r"):
        raise NotImplementedError(
            f"kind={kind!r} is not ported yet (ROADMAP.md, queue 1, item 5: "
            "real transforms)")
    if kind != "c2c":
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
    device="cpu",
) -> Plan:
    """Build an FFT plan (the arguments of ``tpufft.plan_fft``, plus the
    ``device`` that numpy input is moved to)."""
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
        device=str(torch.device(device)),
    )


def _logical_dtype(x):
    """The plan dtype for an input: its own dtype, or c64/c128 for planes."""
    if isinstance(x, SplitComplex):
        return (torch.complex128 if x.dtype == torch.float64
                else torch.complex64)
    if isinstance(x, torch.Tensor):
        return x.dtype
    return np.asarray(x).dtype


def _plan_for(x, axes, s, inverse, norm, bases, config, device):
    shape = x.shape if isinstance(x, (SplitComplex, torch.Tensor)) \
        else np.shape(x)
    return plan_fft(
        shape, _logical_dtype(x), axes=axes, s=s, inverse=inverse,
        norm=norm, bases=bases, config=config, device=device,
    )


def fft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
        device="cpu"):
    """1-D complex FFT (real input allowed; full spectrum out)."""
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, False, norm, bases, config, device)(x)


def ifft(x, n=None, axis=-1, norm=None, *, bases=None, config=None,
         device="cpu"):
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, True, norm, bases, config, device)(x)


def fftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
         device="cpu"):
    return _plan_for(x, axes, s, False, norm, bases, config, device)(x)


def ifftn(x, s=None, axes=None, norm=None, *, bases=None, config=None,
          device="cpu"):
    return _plan_for(x, axes, s, True, norm, bases, config, device)(x)


def fft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return fftn(x, s=s, axes=axes, norm=norm, **kw)


def ifft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return ifftn(x, s=s, axes=axes, norm=norm, **kw)
