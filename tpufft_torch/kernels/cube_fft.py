"""Batched 3-D C2C FFT over the three trailing axes (K5): the CUDA kernel,
its wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_3d``, the Pallas TPU
kernel that runs a plan's trailing cube in one pass. The contract is the
pair kernel's: (pre, n1, n2, n3) planes stored in f32 or bf16, f32
arithmetic, a forward/inverse flag and one real scale applied once at the
store.

The CUDA kernel (``csrc/cluster_fft.cu``) reads and writes the planes once
where three axis passes would do it three times. A cube is split along n1
over a thread-block cluster of C blocks that exchange its columns through
distributed shared memory; C, one of 1, 2, 4, 8, 16, divides n1 and n2*n3
and leaves at most 16384 elements a block, and at most 2048 where it can
(:func:`pick_cluster`).
So the envelope (:func:`supported`) is n1, n2, n3 >= 2, each inside the
minor-axis kernel's radix envelope, and n1*n2*n3 <= 262144 (64^3) with
such a C. C = 16 is a non-portable cluster size; :func:`active_clusters`
reports how many clusters the card holds at once, and a launch raises
RuntimeError when that is 0.

The kernel has two forms (:func:`form`): cubes whose axes are powers of
two up to 64 run the line form, each line's FFT in the registers of a few
lanes of a warp that exchange values by shuffles; every other cube in the
envelope runs the stage form, the shared Stockham stages over the tile.

``fft_cube`` is the wrapper: a CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises. ``launches`` counts its launches,
``reference_cuda_calls`` runs of the plain version on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import minor_fft

__all__ = [
    "CLUSTER_SIZES",
    "MAX_SHARE",
    "active_clusters",
    "cluster_size",
    "fft_cube",
    "fft_cube_reference",
    "form",
    "launches",
    "pick_cluster",
    "reference_cuda_calls",
    "reset_counts",
    "stages_fit",
    "supported",
]

MAX_SHARE = 16384  # elements a block holds, K4's largest slice
SMALL_SHARE = 2048  # a block of 256 threads, four blocks an SM
CLUSTER_SIZES = (1, 2, 4, 8, 16)
LINE_LENGTHS = (2, 4, 8, 16, 32, 64)  # axes of the kernel's line form

launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global launches, reference_cuda_calls
    launches = 0
    reference_cuda_calls = 0


def pick_cluster(n1: int, inner: int) -> int | None:
    """The cluster size for a tile of n1 x ``inner`` elements split along
    n1: among the C in ``CLUSTER_SIZES`` that divide n1 and ``inner`` with
    (n1 / C) * inner <= ``MAX_SHARE``, the smallest whose share is at most
    ``SMALL_SHARE``, else the largest (the smallest share). Small blocks
    share an SM (2048 elements: 256 threads, four blocks an SM), so one
    block's loads overlap another's stages; a block of 16384 runs alone on
    its SM. On the H100, K6 at (64, 128) ran fastest at 2048 elements a
    block (PERF.md). None if no C fits."""
    fits = [c for c in CLUSTER_SIZES
            if n1 % c == 0 and inner % c == 0
            and (n1 // c) * inner <= MAX_SHARE]
    small = [c for c in fits if (n1 // c) * inner <= SMALL_SHARE]
    return small[0] if small else (fits[-1] if fits else None)


def cluster_size(n1: int, n2: int, n3: int) -> int | None:
    """Blocks a cube's cluster takes (:func:`pick_cluster` of n1 and
    n2*n3); None outside the envelope."""
    return pick_cluster(int(n1), int(n2) * int(n3))


def form(n1: int, n2: int, n3: int) -> str | None:
    """Which form of the kernel transforms the cube: ``"lines"`` where
    every axis is in ``LINE_LENGTHS`` and a block's n1-columns, n2*n3 / C,
    are even (they go in pairs), else ``"stages"``; None without a
    cluster size. Mirrors ``line_cube`` in ``csrc/cluster_fft.cu``, which
    makes the choice at the launch."""
    c = cluster_size(n1, n2, n3)
    if c is None:
        return None
    lines = (all(int(n) in LINE_LENGTHS for n in (n1, n2, n3))
             and int(n2) * int(n3) // c % 2 == 0)
    return "lines" if lines else "stages"


def stages_fit(n: int, rows: int, share: int) -> bool:
    """Can ``rows`` rows of length n run their stages in the block that
    holds ``share`` elements? The kernels hold at most 8 values a thread
    (``csrc/cluster_fft.cu``: ``block_shape``, ``chunk_rows``): more rows
    than one such pass covers run in chunks of whole rows starting at a
    multiple of 16 elements, which some odd n above 512 do not allow."""
    threads = min(1024, (-(-share // 8) + 31) // 32 * 32)
    if rows * n <= 8 * threads:
        return True
    low = n & -n
    align = 1 if low >= 16 else 16 // low
    chunk = 8 * threads // n
    return chunk - chunk % align > 0


def supported(n1: int, n2: int, n3: int, dtype) -> bool:
    """Is the (n1, n2, n3) cube in storage ``dtype`` inside the kernel's
    envelope?"""
    n1, n2, n3 = int(n1), int(n2), int(n3)
    if not (min(n1, n2, n3) >= 2
            and all(minor_fft.supported(n, dtype) for n in (n1, n2, n3))):
        return False
    c = cluster_size(n1, n2, n3)
    if c is None:
        return False
    share = n1 // c * n2 * n3
    return (stages_fit(n2, n1 // c * n3, share)
            and stages_fit(n3, n1 // c * n2, share)
            and stages_fit(n1, share // n1, share))


@functools.lru_cache(maxsize=None)
def active_clusters(n1: int, n2: int, n3: int, bf16: bool,
                    device_index: int, fused: bool = False) -> int:
    """How many clusters of the kernel at this cube the card holds at once
    (``cudaOccupancyMaxActiveClusters``; needs the card); ``fused``: of
    its fused-storage form K16 (``kernels/fused_fft``)."""
    lib = _build.load()
    query = (lib.tpufft_cube_fused_active_clusters if fused
             else lib.tpufft_cube_active_clusters)
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = query(n1, n2, n3, cluster_size(n1, n2, n3), int(bf16),
                    ctypes.byref(out))
    if err != 0:
        raise RuntimeError(
            f"cube_fft: cudaOccupancyMaxActiveClusters failed: CUDA error "
            f"{err}")
    return out.value


def _launch(xr, xi, inverse: bool, scale: float):
    pre, n1, n2, n3 = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if pre == 0:
        return yr, yi, False
    lib = _build.load()
    bf16 = xr.dtype == torch.bfloat16
    c = cluster_size(n1, n2, n3)
    if active_clusters(n1, n2, n3, bf16, xr.device.index or 0) == 0:
        raise RuntimeError(
            f"cube_fft: cudaOccupancyMaxActiveClusters reports 0 clusters "
            f"of {c} blocks for the cube {(n1, n2, n3)}: the card cannot "
            "hold one")
    rads = [minor_fft.radices(n) for n in (n1, n2, n3)]
    arrs = [(ctypes.c_int * len(r))(*r) for r in rads]
    with torch.cuda.device(xr.device):
        tws = [minor_fft._device_twiddles(n, bool(inverse), xr.device)
               for n in (n1, n2, n3)]
        err = lib.tpufft_cube_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            *(t.data_ptr() for t in tws), pre, n1, n2, n3, c,
            arrs[0], len(rads[0]), arrs[1], len(rads[1]), arrs[2],
            len(rads[2]), int(bool(inverse)), float(scale), int(bf16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_cube(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the three trailing axes of the (pre, n1, n2, n3) planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_cube_reference(xr, xi, inverse=inverse, scale=scale)
    minor_fft.check_planes("cube_fft", xr, xi, 4)
    if not supported(*xr.shape[1:], xr.dtype):
        raise ValueError(
            f"cube_fft: cube {tuple(xr.shape[1:])} is outside the kernel's "
            f"envelope (n1, n2, n3 >= 2, a cluster of at most 16 blocks of "
            f"<= {MAX_SHARE} elements, prime factors <= "
            f"{minor_fft.MAX_PRIME})")
    yr, yi, launched = _launch(xr, xi, inverse, scale)
    launches += launched
    return yr, yi


def fft_cube_reference(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the minor-axis plain version
    along n3, n2 and n1, in f32, with one rounding to the storage dtype;
    any device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    return minor_fft.fft_axes_reference(xr, xi, (3, 2, 1), inverse=inverse,
                                        scale=scale)
