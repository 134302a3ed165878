"""Batched 2-D C2C FFT over the two trailing axes: the CUDA kernel, its
wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_2d``, the Pallas TPU
kernel that runs a plan's trailing pair of axes in one pass (without its
``n2_io`` fused pad/crop, which waits for the rectangular kernel). The
contract is the minor-axis kernel's: (pre, n1, n2) planes stored in f32 or
bf16, f32 arithmetic, a forward/inverse flag and one real scale applied
once at the store.

The CUDA kernel (``csrc/pair_fft.cu``) holds whole (n1, n2) slices in
shared memory, so it reads and writes the planes once where two axis
passes would do it twice. Its envelope (:func:`supported`): n1, n2 >= 2,
each inside the minor-axis kernel's radix envelope, and n1*n2 <= 16384
(128 KB of f32 complex; 139 KB with the bank padding).

``fft_pair`` is the wrapper: a CPU tensor runs ``fft_pair_reference``; a
CUDA tensor launches the kernel or raises. ``launches`` counts launches,
``reference_cuda_calls`` runs of the plain version on CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import minor_fft

__all__ = [
    "MAX_AREA",
    "fft_pair",
    "fft_pair_reference",
    "launches",
    "reference_cuda_calls",
    "reset_counts",
    "supported",
]

MAX_AREA = 16384  # one f32 complex slice must fit the 227 KB of shared memory

launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global launches, reference_cuda_calls
    launches = 0
    reference_cuda_calls = 0


def supported(n1: int, n2: int, dtype) -> bool:
    """Is the (n1, n2) pair in storage ``dtype`` inside the kernel's
    envelope?"""
    n1, n2 = int(n1), int(n2)
    return (n1 >= 2 and n2 >= 2 and n1 * n2 <= MAX_AREA
            and minor_fft.supported(n1, dtype)
            and minor_fft.supported(n2, dtype))


def _check_launch_args(xr: torch.Tensor, xi: torch.Tensor) -> None:
    minor_fft.check_planes("pair_fft", xr, xi, 3)
    if not supported(xr.shape[1], xr.shape[2], xr.dtype):
        raise ValueError(
            f"pair_fft: pair {tuple(xr.shape[1:])} is outside the kernel's "
            f"envelope (n1, n2 >= 2, n1 * n2 <= {MAX_AREA}, prime factors "
            f"<= {minor_fft.MAX_PRIME})")


def fft_pair(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform both trailing axes of the (pre, n1, n2) planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_pair_reference(xr, xi, inverse=inverse, scale=scale)
    _check_launch_args(xr, xi)
    pre, n1, n2 = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if pre == 0:
        return yr, yi
    lib = _build.load()
    rad1, rad2 = minor_fft.radices(n1), minor_fft.radices(n2)
    arr1 = (ctypes.c_int * len(rad1))(*rad1)
    arr2 = (ctypes.c_int * len(rad2))(*rad2)
    with torch.cuda.device(xr.device):
        tw1 = minor_fft._device_twiddles(n1, bool(inverse), xr.device)
        tw2 = minor_fft._device_twiddles(n2, bool(inverse), xr.device)
        err = lib.tpufft_pair_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw1.data_ptr(), tw2.data_ptr(), pre, n1, n2, arr1, len(rad1),
            arr2, len(rad2), int(bool(inverse)), float(scale),
            int(xr.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_fft launch failed: CUDA error {err}")
    launches += 1
    return yr, yi


def fft_pair_reference(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the minor-axis plain version
    along n2, then along n1 (moved minor), in f32, with one rounding to the
    storage dtype; any device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    store = xr.dtype
    pre, n1, n2 = xr.shape
    zr, zi = minor_fft.fft_minor_reference(
        xr.float().reshape(-1, n2), xi.float().reshape(-1, n2),
        inverse=inverse, scale=1.0)
    zr = zr.reshape(pre, n1, n2).transpose(1, 2).reshape(-1, n1)
    zi = zi.reshape(pre, n1, n2).transpose(1, 2).reshape(-1, n1)
    zr, zi = minor_fft.fft_minor_reference(zr, zi, inverse=inverse,
                                           scale=scale)
    zr = zr.reshape(pre, n2, n1).transpose(1, 2)
    zi = zi.reshape(pre, n2, n1).transpose(1, 2)
    return zr.contiguous().to(store), zi.contiguous().to(store)
