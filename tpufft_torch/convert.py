"""Carry state across from tpufft.

The library has no learned weights: its state is a plan and the planes it
runs on. These helpers take plain Python and numpy values, duck-typed, so
the port never imports tpufft:

    tp = tpufft.plan_fft(...)
    plan = plan_from_fields(tp.shape, tp.dtype, tp.axes, tp.lengths,
                            tp.bases, tp.inverse, tp.norm, tp.kind,
                            dataclasses.asdict(tp.config))
"""

from __future__ import annotations

import numpy as np
import torch

from .api import Plan, _check_ported
from .config import PlanConfig
from .core import SplitComplex, dtype_name

__all__ = ["plan_from_fields", "split_from_numpy"]


def plan_from_fields(shape, dtype, axes, lengths, bases, inverse, norm, kind,
                     config_dict, *, device="cpu") -> Plan:
    """The port's ``Plan`` with the field values of a ``tpufft.Plan``
    (``config_dict`` holds the fields of its ``PlanConfig``). For a c2r
    plan, ``lengths[-1]`` is the real output length, as in tpufft."""
    _check_ported(kind, "natural")
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
        device=str(torch.device(device)),
    )


def split_from_numpy(re, im, device="cpu") -> SplitComplex:
    """``SplitComplex`` planes on ``device`` from two real numpy arrays."""
    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SplitComplex(plane(re), plane(im))
