"""Split-complex Stockham execution core in torch ops (counterpart of
``tpufft/core.py``).

Complex data moves through the port as split real/imag planes
(``SplitComplex``). This module is the port's torch-op path: it serves
float64 planes (the CUDA kernel stores f32 or bf16 only), lengths outside
the kernel's envelope, and ``backend="xla"``, on whatever device the
planes lie. Each Stockham stage is the complex contraction with the radix
DFT matrix written as real einsums, then the twiddle multiply, then the
(r, m) -> (m, r) swap; after the last stage the planes hold the DFT in
natural order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .planner import stage_schedule
from .twiddle import stage_tables

__all__ = [
    "SplitComplex",
    "dtype_name",
    "real_dtype_for",
    "stockham_split_last_axis",
    "fft_along_axis",
]


class SplitComplex(NamedTuple):
    """A complex array as two real tensors of the same shape and dtype."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return tuple(self.re.shape)

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device

    def conj(self) -> "SplitComplex":
        return SplitComplex(self.re, -self.im)

    def complex(self) -> torch.Tensor:
        """Combine to one complex tensor on the planes' device (bf16
        planes are widened to f32 first)."""
        re, im = self.re, self.im
        if re.dtype == torch.bfloat16:
            re, im = re.float(), im.float()
        return torch.complex(re, im)

    def numpy(self) -> np.ndarray:
        """Combine to a host numpy complex array."""
        return self.complex().detach().cpu().numpy()


def dtype_name(dtype) -> str:
    """Canonical name ("complex64", "float32", ...) of a torch dtype, a
    numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def real_dtype_for(dtype) -> torch.dtype:
    """Plane dtype for a plan dtype: float64 for complex128/float64,
    float32 otherwise."""
    if dtype_name(dtype) in ("complex128", "float64"):
        return torch.float64
    return torch.float32


def _einsum(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    # out[..., j, p, q] = sum_b w[j, b] * a[..., b, p, q]
    return torch.einsum("jb,...bpq->...jpq", w, a)


def stockham_split_last_axis(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    bases: tuple[int, ...],
    *,
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixed-radix Stockham FFT over the last axis, split-plane arithmetic.

    ``ar``/``ai``: (..., N) real planes; ``ai=None`` means a real input.
    ``scale`` is folded into the last stage's twiddles.
    """
    n = ar.shape[-1]
    rdt, dev = ar.dtype, ar.device
    if ai is None:
        ai = torch.zeros_like(ar)
    tables = stage_tables(n, tuple(bases), bool(inverse), float(scale))
    if not tables:
        return ar * scale, ai * scale

    def const(t: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(t), dtype=rdt, device=dev)

    pre = tuple(ar.shape[:-1])
    for st, w, tw in tables:
        r, m, s = st.radix, st.m, st.s
        wr, wi = const(w.real), const(w.imag)
        a_r = ar.reshape(pre + (r, m, s))
        a_i = ai.reshape(pre + (r, m, s))
        cr = _einsum(wr, a_r) - _einsum(wi, a_i)
        ci = _einsum(wr, a_i) + _einsum(wi, a_r)
        twr, twi = const(tw.real)[:, :, None], const(tw.imag)[:, :, None]
        cr, ci = twr * cr - twi * ci, twr * ci + twi * cr
        ar = cr.transpose(-3, -2).reshape(pre + (n,))
        ai = ci.transpose(-3, -2).reshape(pre + (n,))
    return ar, ai


def fft_along_axis(
    ar: torch.Tensor,
    ai: torch.Tensor | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stockham FFT along an arbitrary axis (moved minor and back)."""
    n = ar.shape[axis]
    stage_schedule(n, tuple(bases))  # validate early with a clear error
    mr = ar.movedim(axis, -1)
    mi = None if ai is None else ai.movedim(axis, -1)
    outr, outi = stockham_split_last_axis(
        mr, mi, tuple(bases), inverse=inverse, scale=scale
    )
    return outr.movedim(-1, axis), outi.movedim(-1, axis)
