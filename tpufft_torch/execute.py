"""Per-axis dispatch (counterpart of ``tpufft/execute.py``).

For each transformed axis, decide by predicate, before any launch:

* a length and storage dtype inside the CUDA kernel's envelope
  (``kernels/minor_fft.supported``) go to the minor-axis kernel wrapper,
  which launches the kernel for CUDA tensors and runs its plain version for
  CPU tensors; a non-minor axis is moved minor, made contiguous, and moved
  back;
* anything else (float64, lengths outside the envelope, ``backend="xla"``)
  runs the torch-op Stockham of ``core.py`` on the planes' device, bf16
  planes widened to f32 around it;
* ``backend="pallas"`` outside the envelope raises ValueError.

tpufft's two-pass split and Bluestein paths for longer lengths are not
ported yet (see ROADMAP.md); those lengths run the Stockham.

``fft_axis`` is differentiable through ``_FFTAxis``: the split-plane DFT is
the real-linear map [[Fr, -Fi], [Fi, Fr]] with F symmetric, so its
transpose applied to g is the same transform with the opposite sign and the
same scale.
"""

from __future__ import annotations

import torch

from . import core
from .config import PlanConfig
from .kernels import minor_fft

__all__ = ["fft_axis"]


def _fft_minor_axis(ar, ai, axis: int, *, inverse: bool, scale: float):
    """The minor-axis kernel wrapper on any axis of the planes."""
    if ai is None:
        ai = torch.zeros_like(ar)
    n = ar.shape[axis]
    moved = axis != ar.ndim - 1
    if moved:
        ar, ai = ar.movedim(axis, -1), ai.movedim(axis, -1)
    shape = ar.shape
    outr, outi = minor_fft.fft_minor(
        ar.reshape(-1, n).contiguous(), ai.reshape(-1, n).contiguous(),
        inverse=inverse, scale=scale)
    outr, outi = outr.reshape(shape), outi.reshape(shape)
    if moved:
        outr, outi = outr.movedim(-1, axis), outi.movedim(-1, axis)
    return outr, outi


def _fft_axis_impl(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool,
    scale: float,
    config: PlanConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform one axis of the split planes on the path the predicates
    choose."""
    n = ar.shape[axis]
    if config.backend != "xla" and minor_fft.supported(n, ar.dtype):
        return _fft_minor_axis(ar, ai, axis, inverse=inverse, scale=scale)
    if config.backend == "pallas":
        if ar.dtype not in minor_fft.STORAGE_DTYPES:
            raise ValueError(
                f"backend='pallas' requested but axis length {n} (dtype "
                f"{ar.dtype}) is not supported by the fused kernel; use "
                "backend='auto' for automatic fallback"
            )
        raise ValueError(
            f"backend='pallas' requested but axis length {n} is not "
            "factorable into kernel-supported components; use "
            "backend='auto' for automatic fallback"
        )
    bf16 = ar.dtype == torch.bfloat16
    if bf16:
        ar = ar.float()
        ai = None if ai is None else ai.float()
    outr, outi = core.fft_along_axis(
        ar, ai, axis, bases, inverse=inverse, scale=scale
    )
    if bf16:
        outr, outi = outr.to(torch.bfloat16), outi.to(torch.bfloat16)
    return outr, outi


class _FFTAxis(torch.autograd.Function):
    """Differentiable one-axis transform; the backward is the transform of
    the opposite sign with the same scale. A real input (``ai=None``) gets
    only the real plane of that result as its gradient."""

    @staticmethod
    def forward(ctx, ar, ai, axis, bases, inverse, scale, config):
        ctx.args = (axis, bases, inverse, scale, config)
        ctx.real_input = ai is None
        return _fft_axis_impl(ar, ai, axis, bases, inverse=inverse,
                              scale=scale, config=config)

    @staticmethod
    def backward(ctx, gr, gi):
        axis, bases, inverse, scale, config = ctx.args
        br, bi = _FFTAxis.apply(gr, gi, axis, bases, not inverse, scale,
                                config)
        return br, (None if ctx.real_input else bi), None, None, None, None, None


def fft_axis(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool,
    scale: float,
    config: PlanConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform one axis of the split planes (differentiable)."""
    return _FFTAxis.apply(ar, ai, axis % ar.ndim, tuple(bases),
                          bool(inverse), float(scale), config)
