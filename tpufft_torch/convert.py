"""Carry state across from tpufft.

The library has no learned weights: its state is a plan and the planes it
runs on. These helpers take plain Python and numpy values, duck-typed, so
the port never imports tpufft:

    tp = tpufft.plan_fft(...)
    plan = plan_from_fields(tp.shape, tp.dtype, tp.axes, tp.lengths,
                            tp.bases, tp.inverse, tp.norm, tp.kind,
                            dataclasses.asdict(tp.config), layout=tp.layout,
                            logical_shape=tp.logical_shape,
                            logical_axis=tp.logical_axis,
                            logical_perm=tp.logical_perm)

A transform-major or lane-fused plan comes across with the same physical
shape, so data packed for one runs on the other with the same results.

A filter or chirp-z plan's fields are its parameters:

    tf = tpufft.plan_filter(...)
    plan = filter_plan_from_fields(tf.n, tf._c, tf.axis,
                                   dataclasses.asdict(tf.config))
    tc = tpufft.CZT(...)
    plan = czt_plan_from_fields(tc.n, tc.m, tc.w, tc.a,
                                dataclasses.asdict(tc.config))

A short-time FFT's fields are its (scaled) window, hop and the rest of
its state:

    ts = tpufft.ShortTimeFFT(...)
    sft = short_time_fft_from_fields(ts.win, ts.hop, ts.fs, ts.fft_mode,
                                     ts.mfft, ts.dual_win, ts.scaling,
                                     ts.phase_shift)
"""

from __future__ import annotations

import cmath

import numpy as np
import torch

from .api import Plan, _check_kind_layout, numpy_device
from .config import PlanConfig
from .core import SplitComplex, dtype_name
from .czt import CZT
from .shorttime import ShortTimeFFT
from .signal import FilterPlan, plan_filter

__all__ = ["czt_plan_from_fields", "filter_plan_from_fields",
           "plan_from_fields", "short_time_fft_from_fields",
           "split_from_numpy"]


def plan_from_fields(shape, dtype, axes, lengths, bases, inverse, norm, kind,
                     config_dict, *, device=None, layout="natural",
                     logical_shape=None, logical_axis=None,
                     logical_perm=None) -> Plan:
    """The port's ``Plan`` with the field values of a ``tpufft.Plan``
    (``config_dict`` holds the fields of its ``PlanConfig``). For a c2r
    plan, ``lengths[-1]`` is the real output length, as in tpufft. A
    layout plan carries its ``layout``, ``logical_shape``,
    ``logical_axis`` and ``logical_perm`` as they are."""
    _check_kind_layout(kind, layout)

    def ints(v):
        return None if v is None else tuple(int(d) for d in v)

    return Plan(
        shape=tuple(int(d) for d in shape),
        dtype=dtype_name(dtype),
        axes=tuple(int(a) for a in axes),
        lengths=tuple(int(n) for n in lengths),
        bases=tuple(tuple(int(r) for r in b) for b in bases),
        inverse=bool(inverse),
        norm=norm,
        kind=kind,
        config=PlanConfig(**dict(config_dict)),
        device=None if device is None else str(torch.device(device)),
        layout=layout,
        logical_shape=ints(logical_shape),
        logical_axis=None if logical_axis is None else int(logical_axis),
        logical_perm=ints(logical_perm),
    )


def split_from_numpy(re, im, device=None) -> SplitComplex:
    """``SplitComplex`` planes on ``device`` (None: the CUDA device, as for
    every numpy input, ``api.numpy_device``) from two real numpy arrays."""
    dev = numpy_device(device)

    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return SplitComplex(plane(re), plane(im))


def filter_plan_from_fields(n, impulse, axis, config_dict, *,
                            device=None) -> FilterPlan:
    """The port's ``FilterPlan`` with the fields of a ``tpufft.FilterPlan``:
    its length ``n``, its time-domain circular kernel (``_c``) and its
    ``axis``. ``device``: where numpy input runs (None: the CUDA device)."""
    return plan_filter(int(n), impulse=np.asarray(impulse, np.complex128),
                       axis=int(axis), config=PlanConfig(**dict(config_dict)),
                       device=device)


def czt_plan_from_fields(n, m, w, a, config_dict, *, device=None) -> CZT:
    """The port's ``CZT`` with the fields of a ``tpufft.CZT`` (``n``,
    ``m``, ``w``, ``a``). The default spiral (``w = exp(-2 pi i / m)``) is
    rebuilt from its exact angles, as the CZT constructor does for
    ``w=None``. ``device``: where numpy input runs (None: the CUDA
    device)."""
    m = int(m)
    w = complex(w)
    if w == cmath.exp(-2j * np.pi / m):
        w = None
    return CZT(int(n), m, w, complex(a), config=PlanConfig(**dict(config_dict)),
               device=device)


def short_time_fft_from_fields(win, hop, fs, fft_mode, mfft, dual_win,
                               scaling, phase_shift, config_dict=None, *,
                               device=None) -> ShortTimeFFT:
    """The port's ``ShortTimeFFT`` with the state of a
    ``tpufft.ShortTimeFFT``: its window as it stands (already scaled by
    ``scale_to``), ``hop``, ``fs``, ``fft_mode``, ``mfft``, ``dual_win``,
    ``scaling`` (None, "magnitude", "psd" or "unitary") and
    ``phase_shift``; ``config_dict`` holds the fields of its
    ``PlanConfig`` (None: the defaults). ``device``: where numpy input runs
    (None: the CUDA device)."""
    win = np.asarray(win)
    onesided2x = fft_mode == "onesided2X"
    # onesided2X needs a scaling at construction; the window already
    # carries it, so build onesided and set the mode with the scaling
    sft = ShortTimeFFT(
        win, int(hop), float(fs),
        fft_mode="onesided" if onesided2x else fft_mode, mfft=int(mfft),
        dual_win=None if dual_win is None else np.asarray(dual_win),
        phase_shift=None if phase_shift is None else int(phase_shift),
        config=None if config_dict is None
        else PlanConfig(**dict(config_dict)),
        device=device)
    sft._scaling = scaling
    sft._fft_mode = fft_mode
    return sft
