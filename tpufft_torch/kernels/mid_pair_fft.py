"""Batched 2-D C2C FFT over the two middle axes of (pre, n1, n2, L) planes
(K6): the CUDA kernel, its wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_mid_pair``, the Pallas
TPU kernel that runs two adjacent middle axes in one pass; L is the
contiguous batch, as in ``fftn(axes=(1, 2))`` of a channels-last
(B, H, W, C) array. The contract is the pair kernel's: f32 or bf16
storage, f32 arithmetic, a forward/inverse flag and one real scale applied
once at the store.

The CUDA kernel (``csrc/cluster_fft.cu``) reads and writes the planes once
where two strided-axis passes would do it twice. A tile (n1, n2, LANES)
of LANES = 4 contiguous elements of L is split along n1 over a
thread-block cluster of C blocks that exchange its n1-columns through
distributed shared memory; C, one of 1, 2, 4, 8, 16, divides n1 and leaves
at most 16384 elements a block, and at most 2048 where it can
(:func:`cluster_size`): at (64, 128) a cluster of 16 blocks of 2048. A
tile reads half of each 32-byte sector of a row; the tile beside it, run
at the same time, reads the other half from L2. On the H100, 4 lanes ran
faster than 8 (fewer bank conflicts in shared memory, smaller blocks) and
2 (PERF.md, tools/cluster_phases.py). The ragged end of L is masked, never padded.
The envelope (:func:`supported`): n1, n2 >= 2, each inside the minor-axis
kernel's radix envelope, n1*n2 <= 65536 with such a C, any L >= 1.

``fft_mid_pair`` is the wrapper: a CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises. ``launches`` counts its
launches, ``reference_cuda_calls`` runs of the plain version on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import minor_fft
from .cube_fft import MAX_SHARE, pick_cluster, stages_fit

__all__ = [
    "LANES",
    "active_clusters",
    "cluster_size",
    "fft_mid_pair",
    "fft_mid_pair_reference",
    "launches",
    "reference_cuda_calls",
    "reset_counts",
    "supported",
]

LANES = 4  # elements of L a tile takes: 16 bytes of an f32 plane

launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global launches, reference_cuda_calls
    launches = 0
    reference_cuda_calls = 0


def cluster_size(n1: int, n2: int) -> int | None:
    """Blocks a tile's cluster takes (``cube_fft.pick_cluster`` of n1 and
    n2*LANES); None outside the envelope."""
    return pick_cluster(int(n1), int(n2) * LANES)


def supported(n1: int, n2: int, L: int, dtype) -> bool:
    """Are the middle axes (n1, n2) of (pre, n1, n2, L) planes in storage
    ``dtype`` inside the kernel's envelope (n1*n2 <= 65536 with a cluster
    that splits n1 evenly)?"""
    n1, n2 = int(n1), int(n2)
    if not (n1 >= 2 and n2 >= 2 and int(L) >= 1
            and minor_fft.supported(n1, dtype)
            and minor_fft.supported(n2, dtype)):
        return False
    c = cluster_size(n1, n2)
    if c is None:
        return False
    share = n1 // c * n2 * LANES
    return (stages_fit(n2, n1 // c * LANES, share)
            and stages_fit(n1, share // n1, share))


@functools.lru_cache(maxsize=None)
def active_clusters(n1: int, n2: int, bf16: bool, device_index: int) -> int:
    """How many clusters of the kernel at this pair the card holds at once
    (``cudaOccupancyMaxActiveClusters``; needs the card)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.tpufft_mid_pair_active_clusters(
            n1, n2, LANES, cluster_size(n1, n2), int(bf16),
            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(
            f"mid_pair_fft: cudaOccupancyMaxActiveClusters failed: CUDA "
            f"error {err}")
    return out.value


def _launch(xr, xi, inverse: bool, scale: float):
    pre, n1, n2, L = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if pre == 0 or L == 0:
        return yr, yi, False
    lib = _build.load()
    bf16 = xr.dtype == torch.bfloat16
    c = cluster_size(n1, n2)
    if active_clusters(n1, n2, bf16, xr.device.index or 0) == 0:
        raise RuntimeError(
            f"mid_pair_fft: cudaOccupancyMaxActiveClusters reports 0 "
            f"clusters of {c} blocks for the pair {(n1, n2)}: the card "
            "cannot hold one")
    rad1, rad2 = minor_fft.radices(n1), minor_fft.radices(n2)
    arr1 = (ctypes.c_int * len(rad1))(*rad1)
    arr2 = (ctypes.c_int * len(rad2))(*rad2)
    with torch.cuda.device(xr.device):
        tw1 = minor_fft._device_twiddles(n1, bool(inverse), xr.device)
        tw2 = minor_fft._device_twiddles(n2, bool(inverse), xr.device)
        err = lib.tpufft_mid_pair_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw1.data_ptr(), tw2.data_ptr(), pre, n1, n2, L, LANES, c, arr1,
            len(rad1), arr2, len(rad2), int(bool(inverse)), float(scale),
            int(bf16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mid_pair_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_mid_pair(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform axes 1 and 2 of the (pre, n1, n2, L) planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_mid_pair_reference(xr, xi, inverse=inverse, scale=scale)
    minor_fft.check_planes("mid_pair_fft", xr, xi, 4)
    _, n1, n2, L = xr.shape
    if not supported(n1, n2, max(int(L), 1), xr.dtype):
        raise ValueError(
            f"mid_pair_fft: pair {(n1, n2)} is outside the kernel's "
            f"envelope (n1, n2 >= 2, a cluster of at most 16 blocks of "
            f"<= {MAX_SHARE} elements at {LANES} lanes, prime factors <= "
            f"{minor_fft.MAX_PRIME})")
    yr, yi, launched = _launch(xr, xi, inverse, scale)
    launches += launched
    return yr, yi


def fft_mid_pair_reference(xr: torch.Tensor, xi: torch.Tensor, *,
                           inverse: bool, scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the minor-axis plain version
    along n2, then n1, in f32, with one rounding to the storage dtype; any
    device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    return minor_fft.fft_axes_reference(xr, xi, (2, 1), inverse=inverse,
                                        scale=scale)
