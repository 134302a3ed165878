"""Batched 2-D C2C FFT over the two trailing axes: the CUDA kernel, its
wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_2d``, the Pallas TPU
kernel that runs a plan's trailing pair of axes in one pass. The contract
is the minor-axis kernel's: (pre, n1, n2) planes stored in f32 or bf16, f32
arithmetic, a forward/inverse flag and one real scale applied once at the
store. ``_build_2d``'s ``n2_io`` zero-pad direction (m_in < m_out = n2) is
:func:`fft_pair_padded`: (pre, n1, n2_in) planes in, the minor axis
zero-padded to n2 at the kernel's load, (pre, n1, n2) out. Its crop
direction is reached only by tpufft's backward, which the port computes as
the full pair of the gradient and a crop.

The CUDA kernel (``csrc/pair_fft.cu``) holds whole (n1, n2) slices in
shared memory, so it reads and writes the planes once where two axis
passes would do it twice. Its envelope (:func:`supported`): n1, n2 >= 2,
each inside the minor-axis kernel's radix envelope, and n1*n2 <= 16384
(128 KB of f32 complex; 139 KB with the bank padding).

``fft_pair`` and ``fft_pair_padded`` are the wrappers: a CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises.
``launches`` and ``padded_launches`` count their launches,
``reference_cuda_calls`` runs of the plain versions on CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from . import minor_fft

__all__ = [
    "MAX_AREA",
    "fft_pair",
    "fft_pair_padded",
    "fft_pair_padded_reference",
    "fft_pair_reference",
    "launches",
    "padded_launches",
    "reference_cuda_calls",
    "reset_counts",
    "supported",
]

MAX_AREA = 16384  # one f32 complex slice must fit the 227 KB of shared memory

launches = 0
padded_launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches``, ``padded_launches`` and ``reference_cuda_calls``."""
    global launches, padded_launches, reference_cuda_calls
    launches = 0
    padded_launches = 0
    reference_cuda_calls = 0


def supported(n1: int, n2: int, dtype) -> bool:
    """Is the (n1, n2) pair in storage ``dtype`` inside the kernel's
    envelope?"""
    n1, n2 = int(n1), int(n2)
    return (n1 >= 2 and n2 >= 2 and n1 * n2 <= MAX_AREA
            and minor_fft.supported(n1, dtype)
            and minor_fft.supported(n2, dtype))


def _check_launch_args(xr: torch.Tensor, xi: torch.Tensor, n2: int) -> None:
    minor_fft.check_planes("pair_fft", xr, xi, 3)
    if not supported(xr.shape[1], n2, xr.dtype):
        raise ValueError(
            f"pair_fft: pair {(xr.shape[1], n2)} is outside the kernel's "
            f"envelope (n1, n2 >= 2, n1 * n2 <= {MAX_AREA}, prime factors "
            f"<= {minor_fft.MAX_PRIME})")


def _launch(xr, xi, n2: int, inverse: bool, scale: float):
    """The pair kernel on (pre, n1, n2_in) planes zero-padded to n2."""
    pre, n1, n2_in = xr.shape
    yr = xr.new_empty((pre, n1, n2))
    yi = torch.empty_like(yr)
    if pre == 0:
        return yr, yi, False
    lib = _build.load()
    rad1, rad2 = minor_fft.radices(n1), minor_fft.radices(n2)
    arr1 = (ctypes.c_int * len(rad1))(*rad1)
    arr2 = (ctypes.c_int * len(rad2))(*rad2)
    with torch.cuda.device(xr.device):
        tw1 = minor_fft._device_twiddles(n1, bool(inverse), xr.device)
        tw2 = minor_fft._device_twiddles(n2, bool(inverse), xr.device)
        err = lib.tpufft_pair_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw1.data_ptr(), tw2.data_ptr(), pre, n1, n2, n2_in, arr1,
            len(rad1), arr2, len(rad2), int(bool(inverse)), float(scale),
            int(xr.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_pair(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform both trailing axes of the (pre, n1, n2) planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_pair_reference(xr, xi, inverse=inverse, scale=scale)
    _check_launch_args(xr, xi, xr.shape[-1])
    yr, yi, launched = _launch(xr, xi, xr.shape[-1], inverse, scale)
    launches += launched
    return yr, yi


def fft_pair_padded(xr: torch.Tensor, xi: torch.Tensor, *, n2: int,
                    inverse: bool,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the minor axis of the (pre, n1, n2_in) planes to n2 > n2_in
    and transform both trailing axes, in one pass: (pre, n1, n2) out.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global padded_launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_pair_padded_reference(xr, xi, n2=n2, inverse=inverse,
                                          scale=scale)
    n2 = int(n2)
    _check_launch_args(xr, xi, n2)
    if not 1 <= xr.shape[2] < n2:
        raise ValueError(f"pair_fft_padded: input length {xr.shape[2]} "
                         f"must be in [1, {n2})")
    yr, yi, launched = _launch(xr, xi, n2, inverse, scale)
    padded_launches += launched
    return yr, yi


def fft_pair_padded_reference(xr: torch.Tensor, xi: torch.Tensor, *,
                              n2: int, inverse: bool, scale: float
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fft_pair_padded`: ``F.pad`` of the
    minor axis to n2, then :func:`fft_pair_reference`; any device."""
    pad = (0, int(n2) - xr.shape[-1])
    return fft_pair_reference(F.pad(xr, pad), F.pad(xi, pad),
                              inverse=inverse, scale=scale)


def fft_pair_reference(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the minor-axis plain version
    along n2, then along n1 (moved minor), in f32, with one rounding to the
    storage dtype; any device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    return minor_fft.fft_axes_reference(xr, xi, (2, 1), inverse=inverse,
                                        scale=scale)
