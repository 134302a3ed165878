"""Real-to-real transforms: DCT/DST types 1-4 (counterpart of
``tpufft/realtrans.py``; scipy.fft conventions).

Every transform is ``y = x @ M`` for a host-built float64 (n, n) matrix
:func:`_mat`, the norm scale folded in; the inverse matrices use the
partner identities (e.g. idct_backward(type 2) = dct_backward(type 3) /
(2N)) and orthonormal inverses are transposes.

Routing, tpufft's (``realtrans.py:267-273``): f32 rows of a length
2 <= n <= ``R2R_KERNEL_MAX_N`` run the matrix as one pass of the dense
kernel (``kernels/dense_mm.r2r_minor``, K12; its plain version on a CPU
tensor), unless ``backend="xla"``; longer lengths and float64 run a plain
``torch.matmul`` with the f32 or f64 matrix, which tpufft leaves to XLA.
``R2R_KERNEL_MAX_N`` is tpufft's TPU threshold, kept as it is; the H100
crossover against an FFT-based DCT is measured in PERF.md.

Input forms follow the port's API: a tensor in gives a tensor out on its
device, ``SplitComplex`` planes give ``SplitComplex`` (transformed plane by
plane, the matrix being real), a complex input is transformed by linearity
as scipy does, and numpy in gives numpy out, computed on ``device`` (the
CUDA device unless the caller names another). Differentiable: the
backward of ``y = x @ M`` is ``g @ M^T``, the same kernel with the
transposed table.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .api import numpy_device
from .config import PlanConfig
from .core import SplitComplex
from .kernels import dense_mm

__all__ = [
    "dct", "idct", "dst", "idst",
    "dctn", "idctn", "dstn", "idstn",
]

_NORMS = (None, "backward", "ortho", "forward")
R2R_KERNEL_MAX_N = 1024  # tpufft's threshold (a TPU VMEM budget), kept


@functools.lru_cache(maxsize=None)
def _mat(kind: str, type_: int, n: int, norm: str, inverse: bool):
    """(n, n) float64 matrix with y = x @ M == scipy.fft.{kind}{type_}."""
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"norm must be in {_NORMS}, got {norm!r}")
    if type_ not in (1, 2, 3, 4):
        raise ValueError(f"type must be 1, 2, 3 or 4, got {type_}")
    if kind == "dct" and type_ == 1 and n < 2:
        # only DCT-I divides by n-1; DST-I is well-defined at n=1 (scipy
        # accepts it)
        raise ValueError(f"dct type 1 needs n > 1, got {n}")
    if inverse:
        partner = {1: 1, 2: 3, 3: 2, 4: 4}[type_]
        if norm == "ortho":
            return np.ascontiguousarray(_mat(kind, type_, n, "ortho",
                                             False).T)
        base = _mat(kind, partner, n, "backward", False)
        if norm == "backward":
            c = {1: 2.0 * (n - 1) if kind == "dct" else 2.0 * (n + 1),
                 2: 2.0 * n, 3: 2.0 * n, 4: 2.0 * n}[type_]
            return base / c
        return base  # forward: the forward transform carried the 1/c

    j = np.arange(n, dtype=np.float64)[:, None]   # input index
    k = np.arange(n, dtype=np.float64)[None, :]   # output index
    if kind == "dct":
        if type_ == 1:
            if norm == "ortho":
                # orthonormal basis: sqrt(2/(N-1)) * cos, endpoints / sqrt2
                # on both the row and column index
                m = np.cos(np.pi * j * k / (n - 1)) * np.sqrt(2.0 / (n - 1))
                s = np.ones(n)
                s[0] = s[n - 1] = 1.0 / np.sqrt(2.0)
                m = m * s[:, None] * s[None, :]
            else:
                m = 2.0 * np.cos(np.pi * j * k / (n - 1))
                m[0, :] = 1.0
                m[n - 1, :] = (-1.0) ** np.arange(n)
                if norm == "forward":
                    m = m / (2.0 * (n - 1))
        elif type_ == 2:
            m = 2.0 * np.cos(np.pi * (2 * j + 1) * k / (2 * n))
            if norm == "ortho":
                col = np.full(n, np.sqrt(1.0 / (2 * n)))
                col[0] = np.sqrt(1.0 / (4 * n))
                m = m * col[None, :]
            elif norm == "forward":
                m = m / (2.0 * n)
        elif type_ == 3:
            if norm == "ortho":
                m = (np.cos(np.pi * j * (2 * k + 1) / (2 * n))
                     * np.sqrt(2.0 / n))
                m[0, :] = np.sqrt(1.0 / n)
            else:
                m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
                m[0, :] = 1.0
                if norm == "forward":
                    m = m / (2.0 * n)
        else:  # type 4
            m = 2.0 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * n)
            elif norm == "forward":
                m = m / (2.0 * n)
    else:  # dst
        if type_ == 1:
            m = 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * (n + 1))
            elif norm == "forward":
                m = m / (2.0 * (n + 1))
        elif type_ == 2:
            m = 2.0 * np.sin(np.pi * (2 * j + 1) * (k + 1) / (2 * n))
            if norm == "ortho":
                col = np.full(n, np.sqrt(1.0 / (2 * n)))
                col[n - 1] = np.sqrt(1.0 / (4 * n))
                m = m * col[None, :]
            elif norm == "forward":
                m = m / (2.0 * n)
        elif type_ == 3:
            if norm == "ortho":
                m = (np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
                     * np.sqrt(2.0 / n))
                m[n - 1, :] = ((-1.0) ** np.arange(n)) * np.sqrt(1.0 / n)
            else:
                m = 2.0 * np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
                m[n - 1, :] = (-1.0) ** np.arange(n)
                if norm == "forward":
                    m = m / (2.0 * n)
        else:  # type 4
            m = 2.0 * np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * n)
            elif norm == "forward":
                m = m / (2.0 * n)
    return np.ascontiguousarray(m)


def _r2r_kernel_ok(n: int, cfg: PlanConfig) -> bool:
    """Does length n run on K12? Unlike tpufft's rule there is no device
    test: a CPU tensor inside the threshold runs the kernel's plain
    version."""
    return cfg.backend != "xla" and 2 <= n <= R2R_KERNEL_MAX_N


def _table(key: tuple, device, dtype=torch.float32,
           transpose: bool = False) -> torch.Tensor:
    """``_mat(*key)`` (or its transpose) on ``device``, uploaded once."""
    def build():
        m = _mat(*key)
        return m.T if transpose else m

    return dense_mm.device_table(("r2r", key, transpose), build, device,
                                 dtype)


class _R2R(torch.autograd.Function):
    """y = x @ M on K12 for (batch, n) f32 rows; the backward is g @ M^T,
    K12 with the transposed table (tpufft's ``_r2r_diff``)."""

    @staticmethod
    def forward(ctx, x, key):
        ctx.key = key
        return dense_mm.r2r_minor(x.contiguous(),
                                  _table(key, x.device, x.dtype))

    @staticmethod
    def backward(ctx, g):
        return (dense_mm.r2r_minor(
            g.contiguous(), _table(ctx.key, g.device, g.dtype,
                                   transpose=True)), None)


def _resize_minor(x: torch.Tensor, n: int) -> torch.Tensor:
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    return torch.nn.functional.pad(x, (0, n - cur))


def _apply_real(x: torch.Tensor, kind, type_, n, axis, norm, inverse,
                cfg: PlanConfig) -> torch.Tensor:
    """The transform of a real tensor along ``axis``, where it lies."""
    in_dt = x.dtype
    f64 = in_dt == torch.float64
    axis = axis % x.ndim
    n = x.shape[axis] if n is None else int(n)
    key = (kind, type_, n, norm, inverse)
    _mat(*key)  # validate the type/n combination early
    x = x.movedim(axis, -1)
    x = _resize_minor(x, n)
    lead = x.shape[:-1]
    flat = x.reshape(math.prod(lead), n)
    if not f64 and _r2r_kernel_ok(n, cfg):
        out = _R2R.apply(flat.to(torch.float32), key)
    else:
        dt = torch.float64 if f64 else torch.float32
        out = flat.to(dt) @ _table(key, flat.device, dt)
    out = out.reshape(lead + (n,))
    out = out.to(in_dt if in_dt.is_floating_point else torch.float32)
    return out.movedim(-1, axis)


def _apply_r2r(x, kind, type_, n, axis, norm, inverse, config, device):
    cfg = config or PlanConfig()
    norm = "backward" if norm is None else norm
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    args = (kind, type_, n, axis, norm, inverse, cfg)
    if isinstance(x, SplitComplex):
        # transform the planes by linearity (the matrices are real)
        return SplitComplex(_apply_real(x.re, *args),
                            _apply_real(x.im, *args))
    is_np = not isinstance(x, torch.Tensor)
    if is_np:
        x = torch.from_numpy(np.ascontiguousarray(x)).to(
            numpy_device(device))
    if x.is_complex():
        # scipy transforms complex input by linearity
        out = torch.complex(_apply_real(x.real, *args),
                            _apply_real(x.imag, *args))
    else:
        out = _apply_real(x, *args)
    return out.detach().cpu().numpy() if is_np else out


def dct(x, type=2, n=None, axis=-1, norm=None, *, config=None, device=None):
    """Discrete cosine transform (scipy.fft.dct-compatible, types 1-4)."""
    return _apply_r2r(x, "dct", int(type), n, axis, norm, False, config,
                      device)


def idct(x, type=2, n=None, axis=-1, norm=None, *, config=None, device=None):
    return _apply_r2r(x, "dct", int(type), n, axis, norm, True, config,
                      device)


def dst(x, type=2, n=None, axis=-1, norm=None, *, config=None, device=None):
    """Discrete sine transform (scipy.fft.dst-compatible, types 1-4)."""
    return _apply_r2r(x, "dst", int(type), n, axis, norm, False, config,
                      device)


def idst(x, type=2, n=None, axis=-1, norm=None, *, config=None, device=None):
    return _apply_r2r(x, "dst", int(type), n, axis, norm, True, config,
                      device)


def _apply_nd(fn, x, type, s, axes, norm, config, device):
    shape = tuple(x.shape) if isinstance(x, (torch.Tensor, SplitComplex)) \
        else np.shape(x)
    ndim = len(shape)
    if axes is None:
        axes = (tuple(range(-len(s), 0)) if s is not None
                else tuple(range(ndim)))
    axes = tuple(a % ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"all axes must be unique, got {axes}")
    if s is None:
        s = tuple(shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError(f"len(s)={len(s)} must equal len(axes)={len(axes)}")
    is_np = not isinstance(x, (torch.Tensor, SplitComplex))
    out = x
    if is_np:  # one upload and one download for all the axes
        out = torch.from_numpy(np.ascontiguousarray(x)).to(
            numpy_device(device))
    for a, n in zip(axes, s):
        out = fn(out, type=type, n=n, axis=a, norm=norm, config=config)
    return out.detach().cpu().numpy() if is_np else out


def dctn(x, type=2, s=None, axes=None, norm=None, *, config=None,
         device=None):
    """N-dimensional DCT (scipy.fft.dctn-compatible)."""
    return _apply_nd(dct, x, type, s, axes, norm, config, device)


def idctn(x, type=2, s=None, axes=None, norm=None, *, config=None,
          device=None):
    return _apply_nd(idct, x, type, s, axes, norm, config, device)


def dstn(x, type=2, s=None, axes=None, norm=None, *, config=None,
         device=None):
    """N-dimensional DST (scipy.fft.dstn-compatible)."""
    return _apply_nd(dst, x, type, s, axes, norm, config, device)


def idstn(x, type=2, s=None, axes=None, norm=None, *, config=None,
          device=None):
    return _apply_nd(idst, x, type, s, axes, norm, config, device)
